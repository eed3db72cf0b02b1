"""The fleet: the reference's World/Job/ETA/benchmark policy over
generation backends (the local engine, remote sdapi nodes), as the JAX
package's ``scheduler`` package exports it."""

from stable_diffusion_webui_distributed_tpu_torch.scheduler.eta import (  # noqa: F401
    EtaCalibration,
    SAMPLER_SPEED_VS_EULER_A,
    predict_eta,
    record_eta_error,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.worker import (  # noqa: F401
    State,
    WorkerNode,
    LocalBackend,
    StubBackend,
    HTTPBackend,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler.world import (  # noqa: F401
    Job,
    World,
)
