"""int8 serving precision in the port against the JAX package, on the CPU.

``ops/quant.py``: ``int8_dot`` and ``int8_conv`` take the same f32 inputs as
the JAX package's (rows of ties, zero rows and a zero image, odd widths,
stride 2, 1x1): their int8 codes and int32 accumulators must be identical
and their outputs bit-equal. No code differed in any case here: XLA's f32
division and torch's round the same quotients.

The UNet at ``bf16`` (f32 here), ``int8`` and ``int8+conv``, TINY and
TINY_XL, against the JAX UNet built with ``quant_linears`` and
``quant_convs`` on the same seeded weights. Upstream f32 noise of 1e-6
moves a code that sits at a rounding edge, and a random tiny network
passes such a flip on: the JAX TINY UNet itself moves by 2.0e-2 (int8) and
3.3e-2 (int8+conv) relative when its input moves by 1e-6 relative. So the
tolerance is the relative error as measured (TINY: 2.03e-2 / 3.52e-2,
TINY_XL: 1.49e-2 / 2.35e-2; f32: 1.2e-6) with room, not the f32 parity's.

Whole engines on the same weights: the int8 images are the JAX engine's
within the levels such flips add up to over 8 steps (measured: int8 11
levels at most, 1.65 on average; int8+conv 34 and 4.74; PSNR against the
own bf16 run 37.4 and 31.4 dB in the port, 37.7 and 30.8 in the JAX
package), both packages hold
the JAX package's quality floors against their own bf16 run (PSNR >= 20
dB, SSIM >= 0.6, ``tests/test_quality_int8.py``), a ragged coalesced pair
at int8 matches the JAX dispatcher's, and the bookkeeping (the precision
ladder, resolution, the dispatcher's group key, the warmup rungs, the ETA's
per-precision factors) equals the JAX package's. With the stand-in capture
backend of ``tests/test_torch_warmup.py``, an int8 and a bf16 evaluation of
one shape never share a graph.
"""

import functools
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import quality
from stable_diffusion_webui_distributed_tpu.models.configs import TINY as JTINY
from stable_diffusion_webui_distributed_tpu.models.configs import (
    TINY_XL as JTINY_XL,
)
from stable_diffusion_webui_distributed_tpu.models.unet import UNet as JaxUNet
from stable_diffusion_webui_distributed_tpu.ops import quant as jquant
from stable_diffusion_webui_distributed_tpu.pipeline import (
    precision as jprecision,
)
from stable_diffusion_webui_distributed_tpu.pipeline.engine import (
    Engine as JaxEngine,
)
from stable_diffusion_webui_distributed_tpu.pipeline.payload import (
    GenerationPayload as JaxPayload,
)
from stable_diffusion_webui_distributed_tpu.runtime import dtypes as jdtypes
from stable_diffusion_webui_distributed_tpu.runtime.interrupt import (
    GenerationState as JaxState,
)
from stable_diffusion_webui_distributed_tpu.scheduler import eta as jeta
from stable_diffusion_webui_distributed_tpu.serving.bucketer import (
    ShapeBucketer as JaxBucketer,
)
from stable_diffusion_webui_distributed_tpu.serving.dispatcher import (
    ServingDispatcher as JaxDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch import bridge
from stable_diffusion_webui_distributed_tpu_torch.models.configs import (
    TINY,
    TINY_XL,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import quant
from stable_diffusion_webui_distributed_tpu_torch.pipeline import precision
from stable_diffusion_webui_distributed_tpu_torch.pipeline.engine import Engine
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
    b64png_to_array,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import dtypes, graphs
from stable_diffusion_webui_distributed_tpu_torch.runtime.interrupt import (
    GenerationState,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import eta
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher import (
    ServingDispatcher,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)
from test_torch_warmup import Stub, flax_tree

RNG = np.random.default_rng(12)
#: the UNet's relative error against the JAX UNet at each precision (see
#: the module's docstring for the measured values)
UNET_REL = {"bf16": 1e-5, "int8": 5e-2, "int8+conv": 8e-2}
#: the engines' pixels against the JAX engine's: (max, mean) uint8 levels
PIXELS = {"int8": (32, 5.0), "int8+conv": (80, 12.0)}
PSNR_FLOOR_DB = 20.0
SSIM_FLOOR = 0.6


# -- the int8 ops --------------------------------------------------------------

def jax_codes(x, dims):
    """The JAX package's codes and scale (``ops/quant.py``'s lines)."""
    xf = jnp.asarray(x, jnp.float32)
    s = jnp.max(jnp.abs(xf), axis=dims, keepdims=True) / 127.0 + 1e-8
    return np.asarray(jnp.round(xf / s).astype(jnp.int8)), np.asarray(s)


def dot_inputs(rows, k, n):
    x = RNG.standard_normal((rows, k)).astype(np.float32) * 3.0
    x[0] = 0.0  # a zero row: scale eps, codes 0
    # a row whose abs max is 127: its scale rounds to 1.0 in f32, so the
    # halves are exact ties that round to even
    tie = np.resize(np.array([127.0, 2.5, -0.5, 3.5, -6.5, 0.5],
                             np.float32), k)
    x[1] = tie
    w = RNG.standard_normal((k, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("rows,k,n", [(7, 37, 19), (16, 64, 8), (3, 6, 5),
                                      (33, 320, 40)])
def test_int8_dot_codes_accumulators_and_output_match_jax(rows, k, n):
    x, w = dot_inputs(rows, k, n)
    xq, s_x = quant.quantize(torch.from_numpy(x), -1)
    wq, s_w = quant.quantize(torch.from_numpy(w.T.copy()), 1)
    jxq, js_x = jax_codes(x, -1)
    jwq, js_w = jax_codes(w, 0)
    assert np.array_equal(xq.numpy(), jxq)
    assert np.array_equal(wq.numpy(), jwq.T)
    assert np.array_equal(s_x.numpy(), js_x)
    assert np.array_equal(s_w.numpy().reshape(-1), js_w.reshape(-1))
    assert list(xq[1, :6].numpy()) == [127, 2, 0, 4, -6, 0][:min(6, k)]
    out, acc = quant.int8_dot(torch.from_numpy(x),
                              torch.from_numpy(w.T.copy()),
                              accumulators=True)
    jacc = np.asarray(jax.lax.dot_general(
        jnp.asarray(jxq), jnp.asarray(jwq), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), jacc)
    want = np.asarray(jquant.int8_dot(jnp.asarray(x), jnp.asarray(w)))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(out[0].numpy(), np.zeros(n, np.float32))


@pytest.mark.parametrize("kernel,stride,pad,channels", [
    (3, 1, 1, (13, 7)), (3, 2, 1, (8, 8)), (1, 1, 0, (11, 6)),
    (3, 2, 1, (5, 3)),
])
def test_int8_conv_codes_accumulators_and_output_match_jax(kernel, stride,
                                                            pad, channels):
    cin, cout = channels
    x = RNG.standard_normal((3, 9, 11, cin)).astype(np.float32)
    x[2] = 0.0  # a zero image
    k = RNG.standard_normal((kernel, kernel, cin, cout)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = torch.from_numpy(k).permute(3, 2, 0, 1)
    out, acc = quant.int8_conv(xt, kt, (stride, stride), (pad, pad),
                               accumulators=True)
    jxq, _ = jax_codes(x, (1, 2, 3))
    jkq, _ = jax_codes(k, (0, 1, 2))
    jacc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(jxq), jnp.asarray(jkq), window_strides=(stride, stride),
        padding=[(pad, pad)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert np.array_equal(acc.numpy().reshape(jacc.shape), jacc)
    want = np.asarray(jquant.int8_conv(jnp.asarray(x), jnp.asarray(k),
                                       strides=(stride, stride),
                                       padding=[(pad, pad)] * 2))
    got = out.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    assert not got[2].any()


def test_patches_take_any_dtype_and_order_like_the_weight():
    """``F.unfold`` has no int8 kernel; the patches of the codes, dotted
    with the OIHW weight reshaped, are the convolution of the codes."""
    xq = torch.randint(-127, 128, (2, 5, 7, 6), dtype=torch.int8)
    w = torch.randint(-127, 128, (4, 5, 3, 3), dtype=torch.int8)
    patches, ho, wo = quant.conv_patches(xq, (3, 3), (2, 2), (1, 1))
    assert patches.dtype == torch.int8 and (ho, wo) == (4, 3)
    acc = quant.int8_mm(patches, w.reshape(4, -1).t())
    ref = torch.nn.functional.conv2d(xq.double(), w.double(), stride=2,
                                     padding=1)
    assert torch.equal(acc.reshape(2, ho, wo, 4).permute(0, 3, 1, 2),
                       ref.to(torch.int32))


def test_int8_mm_on_the_cpu_is_the_plain_version_and_counts_nothing():
    a = torch.randint(-127, 128, (5, 9), dtype=torch.int8)
    b = torch.randint(-127, 128, (9, 3), dtype=torch.int8)
    before = quant.int8_mm.launches
    assert torch.equal(quant.int8_mm(a, b), (a.long() @ b.long()).int())
    assert quant.int8_mm.launches == before
    with pytest.raises(ValueError, match="int8 codes"):
        quant.int8_mm(a.float(), b)


# -- the UNet at each precision -------------------------------------------------

def seeded_params(jfam, fam):
    """One seeded model for both packages: ``bridge.init_seeded``'s
    weights laid out as the JAX package's Flax tree (its layout from
    ``jax.eval_shape`` of the JAX init, which compiles nothing)."""
    sds = bridge.init_seeded(fam, 0, device="cpu")
    shapes = jax.eval_shape(functools.partial(quality.init_params, jfam))
    tree = {"text_encoder": flax_tree(sds["text_encoder"],
                                      shapes["text_encoder"]),
            "text_encoder_2": None,
            "unet": flax_tree(sds["unet"], shapes["unet"]),
            "vae": {"decoder": flax_tree(sds["vae"],
                                         shapes["vae"]["decoder"]),
                    "encoder": flax_tree(sds["vae_encoder"],
                                         shapes["vae"]["encoder"])}}
    if shapes["text_encoder_2"] is not None:
        tree["text_encoder_2"] = flax_tree(sds["text_encoder_2"],
                                           shapes["text_encoder_2"])
    return tree


@pytest.fixture(scope="module")
def tiny_params():
    return {"tiny": seeded_params(JTINY, TINY),
            "tiny-xl": seeded_params(JTINY_XL, TINY_XL)}


def jax_apply(ju, params, *args, **kw):
    return np.asarray(jax.jit(functools.partial(ju.apply, **kw))(
        {"params": params}, *args))


def unet_pair(tiny_params, name):
    jfam, fam = {"tiny": (JTINY, TINY), "tiny-xl": (JTINY_XL, TINY_XL)}[name]
    params = tiny_params[name]
    mods = bridge.build_modules(fam)
    mods["unet"].load_state_dict(bridge.flax_to_torch(fam, params)["unet"])
    return jfam, params, mods["unet"].eval()


def unet_inputs(jfam):
    x = RNG.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx = RNG.standard_normal(
        (2, 77, jfam.unet.cross_attention_dim)).astype(np.float32)
    added = None
    if jfam.unet.addition_embed_dim:
        added = RNG.standard_normal(
            (2, jfam.unet.projection_input_dim)).astype(np.float32)
    return x, t, ctx, added


@pytest.mark.parametrize("family", ["tiny", "tiny-xl"])
@pytest.mark.parametrize("name", ["bf16", "int8", "int8+conv"])
def test_unet_at_each_precision_matches_jax(tiny_params, family, name):
    jfam, params, unet = unet_pair(tiny_params, family)
    x, t, ctx, added = unet_inputs(jfam)
    spec = precision.from_name(name)
    jspec = jprecision.from_name(name)
    assert spec.flags == jspec.flags
    ju = JaxUNet(jfam.unet, quant_linears=jspec.quant_linears,
                 quant_convs=jspec.quant_convs)
    jargs = [jnp.asarray(a) for a in (x, t, ctx)]
    if added is not None:
        jargs.append(jnp.asarray(added))
    want = jax_apply(ju, params["unet"], *jargs)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   added_cond=None if added is None
                   else torch.from_numpy(added), precision=spec).numpy()
        plain = unet(torch.from_numpy(x), torch.from_numpy(t),
                     torch.from_numpy(ctx),
                     added_cond=None if added is None
                     else torch.from_numpy(added)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= UNET_REL[name], rel
    # the lever engaged: the quantized call is not the plain one
    assert np.array_equal(got, plain) == (name == "bf16")


def test_quantized_layers_are_the_jax_packages(tiny_params, monkeypatch):
    """Exactly the transformer linears at int8, and the ResBlock convs and
    skips, Downsamples and Upsamples besides at int8+conv: counted by
    the port's int8 products and by the JAX package's, one TINY call."""
    jfam, params, unet = unet_pair(tiny_params, "tiny")
    x, t, ctx, _ = unet_inputs(jfam)
    counts = {}
    real = quant.int8_mm

    def counting(a, b):
        counts["n"] += 1
        return real(a, b)

    monkeypatch.setattr(quant, "int8_mm", counting)
    jcounts = {"n": 0}
    jreal_dot, jreal_conv = jquant.int8_dot, jquant.int8_conv

    def jdot(*a, **k):
        jcounts["n"] += 1
        return jreal_dot(*a, **k)

    def jconv(*a, **k):
        jcounts["n"] += 1
        return jreal_conv(*a, **k)

    monkeypatch.setattr(jquant, "int8_dot", jdot)
    monkeypatch.setattr(jquant, "int8_conv", jconv)
    for name in ("int8", "int8+conv"):
        counts["n"] = 0
        jcounts["n"] = 0
        with torch.no_grad():
            unet(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(ctx), precision=precision.from_name(name))
        jspec = jprecision.from_name(name)
        jax_apply(JaxUNet(jfam.unet, quant_linears=jspec.quant_linears,
                          quant_convs=jspec.quant_convs),
                  params["unet"], x, t, ctx)
        assert counts["n"] == jcounts["n"] > 0, name
    # TINY: 3 SpatialTransformers of depth 1, 9 linears each
    assert counts["n"] > 27


# -- the precision ladder ----------------------------------------------------

NAMES = st.one_of(
    st.sampled_from(["", " ", "bf16", "BF16", "bfloat16", "default", "int8",
                     "W8A8", "int8+conv", "int8-conv", "int8_conv", " int8 ",
                     "fp8", None, 8]),
    st.text(max_size=8))


@settings(max_examples=150, deadline=None)
@given(value=NAMES, default=st.sampled_from(["bf16", "int8", "", "x"]))
def test_bucket_precision_matches_jax(value, default):
    assert precision.bucket_precision(value, default) == \
        jprecision.bucket_precision(value, default)


class _P:
    def __init__(self, field, override):
        self.precision = field
        self.override_settings = override


@settings(max_examples=150, deadline=None)
@given(field=NAMES, override=st.one_of(st.none(), NAMES),
       flags=st.tuples(st.booleans(), st.booleans()))
def test_resolve_matches_jax(field, override, flags):
    """The payload's field, then ``override_settings``, then the policy's
    flags (which ``SDTPU_UNET_INT8[_CONV]`` set)."""
    ov = {} if override is None else {"precision": override}
    policy = dtypes.Policy(unet_int8=flags[0], unet_int8_conv=flags[1])
    jpolicy = jdtypes.Policy(unet_int8=flags[0], unet_int8_conv=flags[1])
    got = precision.resolve(_P(field, ov), policy)
    want = jprecision.resolve(_P(field, ov), jpolicy)
    assert (got.name, got.flags, got.active) == \
        (want.name, want.flags, want.active)
    assert precision.policy_default(policy).flags == flags


def test_env_flags_set_the_card_default(monkeypatch):
    import importlib

    monkeypatch.setenv("SDTPU_UNET_INT8_CONV", "1")
    try:
        importlib.reload(dtypes)
        assert precision.policy_default(dtypes.CARD) == \
            precision.PrecisionSpec("int8+conv", False, True)
    finally:
        monkeypatch.delenv("SDTPU_UNET_INT8_CONV")
        importlib.reload(dtypes)
    assert precision.policy_default(dtypes.CARD).name == "bf16"


@pytest.mark.parametrize("extra", [
    {}, {"precision": "int8"}, {"override_settings": {"precision": "W8A8"}},
    {"precision": "int8+conv", "override_settings": {"deepcache": 3,
                                                     "cfg_cutoff": 1.5}},
    {"precision": "nonsense"},
])
def test_group_key_matches_jax(extra):
    """The dispatcher's group key has the JAX package's axes in its order,
    the resolved precision last (both called unbound)."""
    body = dict(prompt="a cow", steps=5, width=64, height=64, **extra)
    got = ServingDispatcher._group_key(None, GenerationPayload(**body))
    want = JaxDispatcher._group_key(None, JaxPayload(**body))
    assert got == want
    assert got[-1] == precision.resolve(GenerationPayload(**body)).name


# -- the ETA's per-precision factors -----------------------------------------

def test_eta_factors_and_predictions_match_jax():
    """The same bf16 and int8 samples give the JAX package's factors,
    MPE windows and predictions; an int8 sample never enters the bf16
    window."""
    cals = {"jax": jeta.EtaCalibration(avg_ipm=12.0),
            "port": eta.EtaCalibration(avg_ipm=12.0)}
    mods = {"jax": jeta, "port": eta}
    pays = {"jax": JaxPayload(steps=20, width=512, height=512),
            "port": GenerationPayload(steps=20, width=512, height=512)}
    rng = np.random.default_rng(3)
    for i in range(40):
        prec = ["", "bf16", "int8", "int8+conv", "int8"][i % 5]
        # mostly within the window, now and then a sample it rejects
        ratio = float(rng.uniform(0.6, 1.8)) if i % 7 else 9.0
        for name, mod in mods.items():
            pred = mod.predict_eta(cals[name], pays[name], precision=prec)
            mod.record_eta_error(cals[name], pred, pred * ratio,
                                 precision=prec)
        assert cals["port"].precision_scale == cals["jax"].precision_scale
        assert cals["port"].eta_percent_error == \
            cals["jax"].eta_percent_error
        for prec in ("", "bf16", "int8", "int8+conv"):
            assert eta.predict_eta(cals["port"], pays["port"],
                                   precision=prec) == \
                jeta.predict_eta(cals["jax"], pays["jax"], precision=prec)
    assert eta.PRECISION_PRIOR == jeta.PRECISION_PRIOR
    assert set(cals["port"].precision_scale) == {"int8", "int8+conv"}


# -- whole engines ------------------------------------------------------------

BODY = dict(prompt="a cow", negative_prompt="blurry", steps=8, width=32,
            height=32, batch_size=2, seed=42)


@pytest.fixture(scope="module")
def engines(tiny_params):
    params = tiny_params["tiny"]
    return (JaxEngine(JTINY, params, chunk_size=4, state=JaxState()),
            Engine(TINY, bridge.flax_to_torch(TINY, params), chunk_size=4,
                   state=GenerationState(), device="cpu"))


@pytest.fixture(scope="module")
def plain_runs(engines):
    jax_e, port_e = engines
    return (jax_e.txt2img(JaxPayload(**BODY)),
            port_e.txt2img(GenerationPayload(**BODY)))


def pixel_gap(a_images, b_images):
    diffs = [np.abs(b64png_to_array(a).astype(int) - b64png_to_array(b))
             for a, b in zip(a_images, b_images)]
    return max(d.max() for d in diffs), float(np.mean(diffs))


@pytest.mark.parametrize("name", ["int8", "int8+conv"])
def test_engine_at_int8_matches_jax_and_keeps_the_floors(engines, plain_runs,
                                                         name):
    jax_e, port_e = engines
    want = jax_e.txt2img(JaxPayload(**BODY, precision=name))
    got = port_e.txt2img(GenerationPayload(**BODY, precision=name))
    assert got.seeds == want.seeds and got.infotexts == want.infotexts
    worst, mean = pixel_gap(got.images, want.images)
    assert worst <= PIXELS[name][0] and mean <= PIXELS[name][1], (worst, mean)
    for run, plain in ((got, plain_runs[1]), (want, plain_runs[0])):
        db = quality.mean_psnr(run.images, plain.images)
        assert PSNR_FLOOR_DB <= db < quality.IDENTICAL_DB, db
        assert quality.mean_ssim(run.images, plain.images) >= SSIM_FLOOR
    # the default request afterwards is the plain bytes: no int8 leaks
    again = port_e.txt2img(GenerationPayload(**BODY))
    assert again.images == plain_runs[1].images


def test_int8_floors_of_the_jax_packages_fast_tier(tiny_params):
    """``tests/test_quality_int8.py``'s per-request case on the port: one
    default engine, 4 steps, batch 1, int8 against bf16."""
    port_e = Engine(TINY, bridge.flax_to_torch(TINY, tiny_params["tiny"]),
                    state=GenerationState(), device="cpu")
    body = dict(prompt="a cow", steps=4, width=32, height=32, batch_size=1,
                seed=42)
    base = port_e.txt2img(GenerationPayload(**body))
    q = port_e.txt2img(GenerationPayload(**body, precision="int8"))
    assert q.images != base.images
    assert quality.mean_psnr(q.images, base.images) >= PSNR_FLOOR_DB
    assert quality.mean_ssim(q.images, base.images) >= SSIM_FLOOR


def concurrently(submit, payloads):
    out = [None] * len(payloads)
    errors = []

    def run(i, p):
        try:
            out[i] = submit(p)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    return out


def test_ragged_pair_at_int8_matches_jax_dispatcher(engines, monkeypatch):
    """Two SD1.5-shaped requests of different heights coalesce into one
    ragged int8 dispatch in both packages; the images agree within the
    int8 engines' levels."""
    jax_e, port_e = engines
    monkeypatch.setenv("SDTPU_RAGGED", "1")
    bodies = [dict(prompt="a cow", steps=4, width=32, height=32, seed=5,
                   precision="int8"),
              dict(prompt="a red cow", steps=4, width=32, height=24, seed=9,
                   precision="int8")]
    ladder = dict(shapes=[(32, 32)], batches=[1, 2])
    METRICS.clear()
    got = concurrently(ServingDispatcher(port_e, ShapeBucketer(**ladder),
                                         window=0.6).submit,
                       [GenerationPayload(**b) for b in bodies])
    summary = METRICS.summary()
    assert summary["dispatches"] == 1 and summary["coalesced_requests"] == 2
    assert summary["precision"] == {"int8": {"dispatches": 1,
                                             "requests": 2}}
    want = concurrently(JaxDispatcher(jax_e, JaxBucketer(**ladder),
                                      window=0.6).submit,
                        [JaxPayload(**b) for b in bodies])
    for g, w in zip(got, want):
        assert g.seeds == w.seeds and g.infotexts == w.infotexts
        worst, mean = pixel_gap(g.images, w.images)
        assert worst <= PIXELS["int8"][0] and mean <= PIXELS["int8"][1]


def test_int8_and_bf16_never_share_a_graph(engines):
    """With the stand-in capture backend: an int8 request and a bf16
    request of one shape capture an entry each; the bf16 request after an
    int8 one replays the bf16 graph and gives the bf16 bytes."""
    _, port_e = engines
    saved = port_e._graphs
    port_e._graphs = graphs.GraphCache(capture=Stub())
    try:
        body = dict(prompt="a cow", steps=3, width=32, height=32, seed=1)
        METRICS.clear()
        plain = port_e.txt2img(GenerationPayload(**body))
        assert len(port_e._graphs) == 1
        q = port_e.txt2img(GenerationPayload(**body, precision="int8"))
        assert len(port_e._graphs) == 2 and q.images != plain.images
        again = port_e.txt2img(GenerationPayload(**body))
        q_again = port_e.txt2img(GenerationPayload(**body, precision="int8"))
        assert len(port_e._graphs) == 2
        assert again.images == plain.images and q_again.images == q.images
        assert METRICS.summary()["compiles"] == {"unet": 2}
        tags = {key[0] for key in port_e._graphs._entries}
        assert {t[1] for t in tags} == {(False, False), (True, False)}
    finally:
        port_e._graphs = saved
