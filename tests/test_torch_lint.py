"""The port's lint (``stable_diffusion_webui_distributed_tpu_torch/analysis``)
against the JAX package's, on the CPU.

Pure AST work: no device, and neither lint imports the code it analyzes.

- the repo gate: the port analyzes clean against its committed allowlist
  (computed once for the module), over at least 90 modules;
- parity: on every file of ``tests/lint_fixtures/`` (at its own path and
  at the package paths the JAX tests spoof for the path-scoped rules, the
  cross-module pair together) the port's ``(rule, line)`` findings equal
  the JAX lint's for every rule carried over as it is; the pins the
  explorer's fixtures lean on (LK005, AT001, LK004) hold;
- the trace rules retargeted at CUDA-graph capture: each fires at its
  pinned lines on its own ``tests/torch_lint_fixtures/`` file (analyzed
  beside the port's ``runtime/graphs.py``), the engine's covered-tag
  pattern is clean, and faults injected into a copy of the real engine
  are found;
- the CLI's exit codes and rule list, the per-module cache, and the
  allowlist mechanics, each beside the JAX lint's.
"""

import ast
import datetime
import json
import os
import subprocess
import sys
import textwrap

import pytest

from stable_diffusion_webui_distributed_tpu import analysis as jax_analysis
from stable_diffusion_webui_distributed_tpu.analysis import (
    __main__ as jax_cli,
)
from stable_diffusion_webui_distributed_tpu.analysis.core import (
    load_module as jax_load_module,
)
from stable_diffusion_webui_distributed_tpu_torch import analysis
from stable_diffusion_webui_distributed_tpu_torch.analysis import (
    __main__ as cli,
)
from stable_diffusion_webui_distributed_tpu_torch.analysis import (
    allowlist as allowlist_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.analysis import (
    cache as cache_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.analysis import core
from stable_diffusion_webui_distributed_tpu_torch.analysis.core import (
    load_module,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "stable_diffusion_webui_distributed_tpu"
PORT = "stable_diffusion_webui_distributed_tpu_torch"
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
TORCH_FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
GRAPHS = f"{PORT}/runtime/graphs.py"
ENGINE = f"{PORT}/pipeline/engine.py"

#: the JAX trace rules, retargeted at CUDA-graph capture
RETARGETED = {"TP001", "TP002", "TP003", "TP004", "RC001", "RC002",
              "DN001"}
CARRIED = set(jax_analysis.RULES) - RETARGETED


def _rule_lines(findings, rules=None):
    return {(f.rule, f.line) for f in findings
            if rules is None or f.rule in rules}


@pytest.fixture(scope="module")
def gate():
    """One full analysis of the port against the committed allowlist,
    through the per-module cache (a hit is the result of an analysis of
    the same sources by the same analyzer), which it leaves warm for the
    CLI's run below."""
    return analysis.run_analysis(REPO, use_cache=True)


# -- the repo gate -----------------------------------------------------------

def test_port_is_clean(gate):
    rendered = "\n".join(f.render() for f in gate.findings)
    assert gate.clean, f"sdtpu-lint findings over the port:\n{rendered}"


def test_analyzes_the_whole_port(gate):
    # the port has ~120 modules; a collapse to a handful means the walker
    # broke and the clean gate above is vacuous
    assert gate.modules >= 90
    assert all(f.path.startswith(PORT + "/") for f in gate.suppressed)


def test_committed_allowlist_is_empty():
    entries, path = allowlist_mod.load()
    assert path.endswith(os.path.join(PORT, "analysis", "allowlist.json"))
    assert entries == []


def test_rules_are_the_jax_rules():
    assert set(analysis.RULES) == set(jax_analysis.RULES)
    assert all(analysis.RULES.values())


def test_lint_imports_neither_jax_nor_torch():
    probe = ("import json, sys\n"
             f"from {PORT}.analysis.__main__ import main\n"
             "rc = main(['--no-allowlist', 'tests/lint_fixtures/env_bad.py'])\n"
             "heavy = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'numpy', "
             f"'{JAX_PKG}'))\n"
             "print(json.dumps([rc, heavy]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [1, []]


def test_cache_has_its_own_file():
    from stable_diffusion_webui_distributed_tpu.analysis import (
        cache as jax_cache,
    )

    assert cache_mod.CACHE_BASENAME != jax_cache.CACHE_BASENAME
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert cache_mod.CACHE_BASENAME in ignored


# -- parity with the JAX lint on its fixtures --------------------------------

def _case(*files):
    """``files``: (fixture name, package subpath or None for the
    fixture's own path), or ("@package", subpath) for a module of each
    package's own sources (the journal registry)."""
    return files


PARITY = {
    **{name[:-3]: _case((name, None))
       for name in sorted(os.listdir(FIXTURES))
       if name.endswith(".py") and not name.startswith("xmod_")},
    "xmod_pair": _case(("xmod_helper.py", None), ("xmod_consumer.py", None)),
    "timing_in_serving": _case(("timing_bad.py", "serving/timing_bad.py")),
    "fleet_in_fleet": _case(("fleet_bad.py", "fleet/fleet_bad.py")),
    "metric_in_serving": _case(("metric_bad.py", "serving/metric_bad.py")),
    "metric_as_registry": _case(("metric_bad.py", "obs/prometheus.py")),
    "journal_with_registry": _case(("@package", "obs/journal.py"),
                                   ("journal_bad.py", "serving/jb.py")),
    "alert_in_serving": _case(("alert_bad.py", "serving/alert_bad.py")),
    "alert_as_registry": _case(("alert_bad.py", "obs/alerts.py")),
    "notify_in_obs": _case(("notify_bad.py", "obs/notify_bad.py")),
    "notify_as_sanctioned": _case(("notify_bad.py", "obs/notify.py")),
    "cache_in_serving": _case(("cache_bad.py", "serving/cache_bad.py")),
    "cache_as_key_module": _case(("cache_bad.py", "cache/keys.py")),
}


def _modules(case, pkg, loader):
    mods, fixture_paths = [], set()
    for name, sub in case:
        if name == "@package":
            rel = f"{pkg}/{sub}"
            mods.append(loader(os.path.join(REPO, rel), rel))
            continue
        rel = f"tests/lint_fixtures/{name}" if sub is None \
            else f"{pkg}/{sub}"
        mods.append(loader(os.path.join(FIXTURES, name), rel))
        fixture_paths.add(rel)
    return mods, fixture_paths


def _carried(case, pkg, lint, loader):
    mods, paths = _modules(case, pkg, loader)
    return {(f.rule, f.line) for f in lint.analyze_modules(mods)
            if f.rule in CARRIED and f.path in paths}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_carried_rules_match_jax(case):
    files = PARITY[case]
    jax = _carried(files, JAX_PKG, jax_analysis, jax_load_module)
    port = _carried(files, PORT, analysis, load_module)
    assert port == jax


def test_parity_fixtures_cover_every_carried_rule():
    seen = set()
    for files in PARITY.values():
        seen |= {r for r, _ in _carried(files, JAX_PKG, jax_analysis,
                                        jax_load_module)}
    # AL001/AL002 are the allowlist's own (TestAllowlist below)
    assert seen == CARRIED - {"AL001", "AL002"}


def _port_fixture(name):
    rel = f"tests/lint_fixtures/{name}"
    return analysis.analyze_modules([load_module(os.path.join(FIXTURES,
                                                              name), rel)])


def test_pins_the_explorer_fixtures_lean_on():
    # tests/test_torch_sched.py runs these two under the explorer only
    assert ("LK005", 13) in _rule_lines(_port_fixture("lockorder_bad.py"))
    assert ("AT001", 24) in _rule_lines(_port_fixture("atomicity_bad.py"))
    assert _rule_lines(_port_fixture("devicehold_bad.py"), {"LK004"}) == {
        ("LK004", 19),  # time.sleep under the lock
        ("LK004", 20),  # block_until_ready under the lock
        ("LK004", 27),  # transitive: callee does requests.get
    }


def test_jax_trace_rules_have_no_subject_in_the_port_lint():
    # jax.jit, lax.scan and donate_argnums are not captures: the port's
    # retargeted rules say nothing of the JAX fixtures
    for name in ("purity_bad.py", "recompile_bad.py", "donate_bad.py",
                 "tracer_escape_bad.py", "cadence_bad.py", "ragged_bad.py",
                 "lora_bad.py"):
        assert not _rule_lines(_port_fixture(name), RETARGETED), name


# -- the trace rules, retargeted at capture ----------------------------------

def _capture_findings(name, source=None):
    """A torch fixture (or ``source`` under its name) analyzed beside the
    port's graph cache, whose ``run`` carries the captures marker."""
    rel = f"tests/torch_lint_fixtures/{name}"
    graphs = load_module(os.path.join(REPO, GRAPHS), GRAPHS)
    if source is None:
        mod = load_module(os.path.join(TORCH_FIXTURES, name), rel)
    else:
        mod = _module_from_source(source, rel)
    return [f for f in analysis.analyze_modules([graphs, mod])
            if f.path == rel]


def _module_from_source(source, rel):
    """A module of the port's lint from source text, at path ``rel``."""
    tree = ast.parse(source)
    mod = core.ModuleInfo(path=rel, tree=tree, source=source,
                          comments=core._collect_comments(source),
                          aliases=core._collect_aliases(tree))
    core._index_scopes(mod)
    return mod


CAPTURE_PINS = {
    "nondeterminism_bad.py": {
        ("TP001", 20),  # time.time() in a GraphCache.run body
        ("TP001", 24),  # torch.randn_like without a generator
        ("TP001", 28),  # random.random()
        ("TP001", 50),  # time.perf_counter() in a torch.cuda.graph block
    },
    "hostread_bad.py": {
        ("TP002", 19),  # a branch on a tensor
        ("TP002", 24),  # .item()
        ("TP002", 34),  # bool() of a tensor
        ("TP002", 51),  # .tolist() between capture_begin and capture_end
    },
    "closure_mutation_bad.py": {
        ("TP003", 20),  # nonlocal counter
        ("TP003", 21),  # closed-over dict
        ("TP003", 22),  # module state
    },
    "pool_escape_bad.py": {
        ("TP004", 23),  # the pool's tensor kept on self
        ("TP004", 24),  # a tensor made in the capture into a self list
    },
    "capture_key_bad.py": {
        ("RC001", 22),  # payload.steps in GraphCache.run's tag
        ("RC001", 38),  # payload.width through a wrapper's tag
    },
    "stale_closure_bad.py": {
        ("RC002", 23),  # closes over cfg_scale the key does not name
        ("RC002", 26),  # a partial binds a bucketed value the key omits
    },
    "replay_reuse_bad.py": {
        ("DN001", 20),  # read after the next replay
        ("DN001", 27),  # loop-carried: the previous iteration's output
    },
    "covered_tag_clean.py": set(),
}


def test_every_torch_fixture_is_pinned():
    assert sorted(CAPTURE_PINS) == sorted(
        n for n in os.listdir(TORCH_FIXTURES) if n.endswith(".py"))


@pytest.mark.parametrize("name", sorted(CAPTURE_PINS))
def test_retargeted_rule_fixture(name):
    assert _rule_lines(_capture_findings(name)) == CAPTURE_PINS[name]


def test_covered_tag_is_what_keeps_the_clean_fixture_clean():
    # drop the precision's flags from the engine-pattern tag: the closure
    # still reads the (bucketed, request-derived) precision, so every
    # replay would reuse the first request's
    with open(os.path.join(TORCH_FIXTURES, "covered_tag_clean.py")) as f:
        source = f.read()
    assert source.count('tag = ("unet", prec.flags, width,') == 1
    bad = source.replace('tag = ("unet", prec.flags, width,',
                         'tag = ("unet", width,')
    found = _capture_findings("covered_tag_clean.py", bad)
    assert {(f.rule, f.symbol) for f in found} == {
        ("RC002", "Engine.denoise_fn.denoise")}
    assert "'prec'" in found[0].message


def test_unbucketed_key_is_rc001_not_rc002():
    # a request value both closed over and named raw in the key is one
    # hazard: the unbounded key
    source = textwrap.dedent("""\
        from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs \\
            import GraphCache


        class Engine:
            def __init__(self):
                self._graphs = GraphCache()

            def denoise(self, payload, x, binding):
                scale = payload.cfg_scale

                def guided(run, call, scalars):
                    return call["x"] * scale

                return self._graphs.run(("g", scale), "unet", guided, {},
                                        {"x": x}, [0.5], binding)
        """)
    found = _capture_findings("injected.py", source)
    assert {f.rule for f in found} == {"RC001"}


def test_capture_key_taint_crosses_modules():
    # a helper in another module returns payload.steps; only the
    # interprocedural summaries see it reach the key
    helper = textwrap.dedent("""\
        def raw_steps(payload):
            return payload.steps
        """)
    consumer = textwrap.dedent("""\
        from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs \\
            import GraphCache

        from tests.torch_lint_fixtures.xhelper import raw_steps

        CACHE = GraphCache()


        def _unet(run, call, scalars):
            return call["x"]


        def render(payload, x, binding):
            return CACHE.run(("unet", raw_steps(payload)), "unet", _unet,
                             {}, {"x": x}, [0.5], binding)
        """)
    mods = [load_module(os.path.join(REPO, GRAPHS), GRAPHS),
            _module_from_source(helper, "tests/torch_lint_fixtures/xhelper.py"),
            _module_from_source(consumer,
                                "tests/torch_lint_fixtures/xconsumer.py")]
    assert _rule_lines(analysis.analyze_modules(mods)) == {("RC001", 14)}
    assert not _rule_lines(analysis.analyze_modules(
        mods, interprocedural=False))


# -- the retargeted rules on the real engine ---------------------------------

def _engine_findings(source):
    """The engine (``source``) analyzed beside the graph cache and the
    precision ladder, which its capture keys go through."""
    mods = [load_module(os.path.join(REPO, rel), rel)
            for rel in (GRAPHS, f"{PORT}/pipeline/precision.py")]
    mods.append(_module_from_source(source, ENGINE))
    return [f for f in analysis.analyze_modules(mods) if f.path == ENGINE]


INJECTIONS = [
    # a clock read in the closure every UNet evaluation captures
    ("        def evaluate(active, r, run, call, scalars):\n",
     "        def evaluate(active, r, run, call, scalars):\n"
     "            time.perf_counter()\n",
     ("TP001", "Engine._make_denoise_fn.evaluate")),
    # a host read in what that closure calls
    ("            tb = scalars[:1].expand(2 * call[\"x\"].shape[0])\n"
     "            both = torch.cat([call[\"x\"], call[\"x\"]])\n"
     "            unet_in",
     "            tb = scalars[:1].expand(2 * call[\"x\"].shape[0])\n"
     "            scalars[0].item()\n"
     "            both = torch.cat([call[\"x\"], call[\"x\"]])\n"
     "            unet_in",
     ("TP002", "Engine._make_denoise_fn.unet_eval")),
    # a second evaluation whose replay overwrites the first's output
    ("            if cache is not None:\n"
     "                cache.count(\"full_evals\")\n"
     "            return guided(x, sigma, out)\n",
     "            again = graphed(tag, kind, functools.partial(evaluate, "
     "active), parts, {\"x\": xin}, [t] + unit_gates, mesh)\n"
     "            if cache is not None:\n"
     "                cache.count(\"full_evals\")\n"
     "            return guided(x, sigma, out) + again\n",
     ("DN001", "Engine._make_denoise_fn.denoise")),
    # an env-derived value the closure reads and the tag does not name
    ("        cfg = torch.tensor(cfg_scale, dtype=torch.float32)\n",
     "        cfg = torch.tensor(cfg_scale, dtype=torch.float32)\n"
     "        boost = env_float(\"SDTPU_BOOST\", 1.0)\n",
     None),
]


def test_faults_injected_into_the_engine_are_found():
    with open(os.path.join(REPO, ENGINE)) as f:
        source = f.read()
    assert not _engine_findings(source)
    for old, new, _ in INJECTIONS:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    # the closure reads the env-derived value
    old = "            return unet_of(r)(unet_in, tb, run[\"ctx\"],\n"
    assert source.count(old) == 1
    source = source.replace(
        old, "            return boost * unet_of(r)(unet_in, tb, "
             "run[\"ctx\"],\n")
    found = {(f.rule, f.symbol) for f in _engine_findings(source)}
    # both captures of the UNet evaluation read the value: the closure
    # of every evaluation, and the stage-ahead path's lambda
    assert found == {expect for _, _, expect in INJECTIONS if expect} | {
        ("RC002", "Engine._make_denoise_fn.denoise"),
        ("RC002", "Engine._make_denoise_fn.denoise_ahead")}


# -- the CLI -----------------------------------------------------------------

def test_cli_lists_the_jax_rules(capsys):
    assert cli.main(["--rules"]) == 0
    port = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert jax_cli.main(["--rules"]) == 0
    jax = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert port == jax == set(jax_analysis.RULES)


def test_cli_exit_codes_match_jax():
    fixture = "tests/lint_fixtures/env_bad.py"
    assert cli.main(["--no-allowlist", fixture]) == \
        jax_cli.main(["--no-allowlist", fixture]) == 1
    clean = "tests/lint_fixtures/clean.py"
    assert cli.main(["--no-allowlist", clean]) == \
        jax_cli.main(["--no-allowlist", clean]) == 0
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["--no-such-flag"])
        assert e.value.code == 2


def test_cli_over_the_port_exits_0(gate, capsys):
    # the gate's analysis left the cache warm: these runs hit it
    assert cli.main([]) == 0
    capsys.readouterr()
    assert cli.main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == [] and out["modules"] >= 90


# -- cache + --changed mechanics ---------------------------------------------

PKG_GOOD = """\
import os


def read(env):
    return env.get("X")
"""

PKG_BAD = """\
import os


def read():
    return os.environ.get("X")  # EV001
"""


def _mini_tree(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text(PKG_GOOD)
    (pkg / "b.py").write_text(PKG_BAD)
    return pkg


def _cached_run(root, **kw):
    return analysis.run_analysis(str(root), paths=["pkg"],
                                 use_allowlist=False, use_cache=True, **kw)


def test_second_run_hits_and_preserves_findings(tmp_path):
    _mini_tree(tmp_path)
    first = _cached_run(tmp_path)
    assert not first.cache_hit
    assert {f.rule for f in first.findings} == {"EV001"}
    assert (tmp_path / cache_mod.CACHE_BASENAME).exists()
    second = _cached_run(tmp_path)
    assert second.cache_hit
    assert _rule_lines(second.findings) == _rule_lines(first.findings)


def test_edit_invalidates_by_content_hash(tmp_path):
    pkg = _mini_tree(tmp_path)
    _cached_run(tmp_path)
    (pkg / "b.py").write_text(PKG_BAD.replace('"X"', '"Y"'))
    third = _cached_run(tmp_path)
    assert not third.cache_hit
    assert {f.rule for f in third.findings} == {"EV001"}


def test_changed_scope_filters_to_dirty_dependents(tmp_path):
    pkg = _mini_tree(tmp_path)
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")
    for cmd in (["git", "init", "-q"], ["git", "add", "."],
                ["git", "commit", "-qm", "seed"]):
        subprocess.run(cmd, cwd=tmp_path, env=env, check=True)
    clean = analysis.run_analysis(str(tmp_path), paths=["pkg"],
                                  use_allowlist=False, changed_only=True)
    assert not clean.findings
    (pkg / "b.py").write_text(PKG_BAD + "\n# touched\n")
    dirty = analysis.run_analysis(str(tmp_path), paths=["pkg"],
                                  use_allowlist=False, changed_only=True)
    assert {f.rule for f in dirty.findings} == {"EV001"}


# -- allowlist mechanics, beside the JAX lint's ------------------------------

ENV_BAD = "tests/lint_fixtures/env_bad.py"


def _write_allowlist(tmp_path, entries):
    p = tmp_path / "allowlist.json"
    p.write_text(json.dumps(entries))
    return str(p)


def _both(**kw):
    """``run_analysis`` of both lints over the env fixture; the findings
    as (rule, symbol) pairs and the number suppressed."""
    out = []
    for lint in (analysis, jax_analysis):
        r = lint.run_analysis(REPO, paths=[ENV_BAD], **kw)
        out.append((sorted((f.rule, f.symbol) for f in r.findings),
                    len(r.suppressed)))
    return out


def test_entry_suppresses_matching_finding(tmp_path):
    path = _write_allowlist(tmp_path, [{
        "rule": "EV001", "path": ENV_BAD, "symbol": "read_knob",
        "reason": "fixture exercise"}])
    port, jax = _both(allowlist_path=path)
    assert port == jax == ([("EV001", "read_flag")], 1)


def test_expired_entry_resurfaces_finding_and_reports_al001(tmp_path):
    path = _write_allowlist(tmp_path, [{
        "rule": "EV001", "path": ENV_BAD, "symbol": "read_knob",
        "reason": "dated debt", "expires": "2026-01-01"}])
    port, jax = _both(allowlist_path=path, today=datetime.date(2026, 6, 1))
    assert port == jax
    assert sorted(r for r, _ in port[0]) == ["AL001", "EV001", "EV001"]
    assert port[1] == 0


def test_entry_still_live_before_expiry(tmp_path):
    path = _write_allowlist(tmp_path, [{
        "rule": "EV001", "path": ENV_BAD, "symbol": "read_knob",
        "reason": "dated debt", "expires": "2026-01-01"}])
    port, jax = _both(allowlist_path=path, today=datetime.date(2025, 6, 1))
    assert port == jax == ([("EV001", "read_flag")], 1)


def test_unused_entry_reports_al002(tmp_path):
    path = _write_allowlist(tmp_path, [{
        "rule": "TP001", "path": "nowhere.py", "symbol": "ghost",
        "reason": "stale"}])
    port, jax = _both(allowlist_path=path)
    assert port == jax
    assert "AL002" in {r for r, _ in port[0]}


def test_unparseable_expiry_fails_safe():
    e = allowlist_mod.Entry(rule="EV001", path="p", symbol="s",
                            reason="r", expires="not-a-date")
    assert e.expired(datetime.date(2020, 1, 1))
