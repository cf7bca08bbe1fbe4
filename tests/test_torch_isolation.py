"""The port stands alone: importing every module of ``repro_torch``, the
chip smoke script and the port's examples (``examples/torch/``) loads no
JAX and nothing of the reference package, and the entry points run on
the card unless the caller asks for the CPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
want = {{"repro_torch.core.cost_model", "repro_torch.core.paradigms",
        "repro_torch.core.partition", "repro_torch.core.hierarchy",
        "repro_torch.core.offload", "repro_torch.core.resilience",
        "repro_torch.serving.cluster", "repro_torch.serving.router",
        "repro_torch.serving.multipool", "repro_torch.configs.yi_6b",
        "repro_torch.configs.starcoder2_3b",
        "repro_torch.configs.mistral_nemo_12b",
        "repro_torch.kernels.feature_compress",
        "repro_torch.kernels.flash_attention",
        "repro_torch.serving.engine", "repro_torch.serving.adaptive",
        "repro_torch.serving.traces", "repro_torch.models.ssm",
        "repro_torch.configs.zamba2_1p2b", "repro_torch.models.xlstm",
        "repro_torch.configs.xlstm_350m", "repro_torch.configs.qwen2_vl_2b",
        "repro_torch.configs.whisper_base",
        "repro_torch.kernels.w8a8_expert",
        "repro_torch.configs.llama4_maverick_400b",
        "repro_torch.core.cnn_zoo", "repro_torch.data.pipeline",
        "repro_torch.training.optimizer", "repro_torch.training.train_loop",
        "repro_torch.training.checkpoint", "repro_torch.launch.train",
        "repro_torch.launch.unbind_ab", "repro_torch.analysis",
        "repro_torch.analysis.__main__", "repro_torch.analysis.callgraph",
        "repro_torch.analysis.costcheck", "repro_torch.analysis.guards",
        "repro_torch.analysis.lint", "repro_torch.analysis.report",
        "repro_torch.analysis.rules", "repro_torch.launch.analyze",
        "repro_torch.sharding", "repro_torch.sharding.mesh_compat",
        "repro_torch.sharding.specs", "repro_torch.sharding.comm",
        "repro_torch.launch.mesh", "repro_torch.launch.collab",
        "repro_torch.launch.roofline", "repro_torch.launch.op_cost",
        "repro_torch.launch.dryrun", "repro_torch.launch.profile_pair",
        "repro_torch.launch.report"}}
assert want <= set(names), sorted(want - set(names))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {repo!r})
import chip_smoke
import glob, importlib.util, os
examples = sorted(glob.glob(os.path.join({repo!r}, "examples", "torch",
                                         "*.py")))
assert len(examples) == 4, examples
for path in examples:
    spec = importlib.util.spec_from_file_location(
        "example_" + os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names))
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(repo=REPO)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 64      # every submodule walked


def test_entry_points_default_to_cuda():
    """Without a card, every entry point called without ``device=`` raises
    instead of falling back to the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (serve, serve_multi_poisson,
                                          serve_multi_tiered_poisson,
                                          serve_poisson, serve_tiered_poisson)
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchScheduler
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run on it")
    cfg = get_config("granite-3-2b-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    cpu_model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchScheduler(cpu_model, cpu_model.init(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_poisson("granite-3-2b-smoke", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("granite-3-2b-smoke", 1, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_tiered_poisson("granite-3-2b-smoke", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_multi_poisson(["granite-3-2b-smoke"], n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_multi_tiered_poisson(["granite-3-2b-smoke"], n_requests=1)
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train("granite-3-2b-smoke", 1, 1, 8)
    from repro_torch.analysis import build_audit_stack
    from repro_torch.launch.analyze import main as analyze
    with pytest.raises(RuntimeError, match="CUDA"):
        build_audit_stack()
    with pytest.raises(RuntimeError, match="CUDA"):
        analyze([])


def test_no_import_line_names_jax_or_reference():
    """Static twin of the subprocess check: no import statement of the
    port, of chip_smoke.py or of the port's examples names jax or the
    reference package."""
    import re
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in (os.path.join(REPO, "src", "repro_torch"),
                os.path.join(REPO, "examples", "torch")):
        for root, _, names in os.walk(top):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
    assert sum("examples" in f for f in files) == 4
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1)
            if pat.match(line)]
    assert not hits, hits


def test_rank_programs_import_no_jax_and_no_reference(tmp_path):
    """A world of 2 gloo ranks runs the rank programs
    (``launch.collab.run_jobs``: a staged forward across 2 pods, the
    expert-parallel MoE, and ``profile_pair --staged``'s counted staged
    runs, raw and int8) with ``jax`` and ``repro`` shadowed by packages
    that raise on import: every rank finishes, so none of them imports
    either."""
    import torch
    from repro_torch.configs import get_config
    for name in ("jax", "repro"):
        (tmp_path / "poison" / name).mkdir(parents=True)
        (tmp_path / "poison" / name / "__init__.py").write_text(
            f"raise ImportError('a rank imported {name}')\n")
    granite = get_config("granite-3-2b-smoke")
    llama = get_config("llama4-maverick-400b-a17b-smoke")
    toks = torch.randint(0, 256, (2, 8), generator=torch.Generator()
                         .manual_seed(0))
    x = torch.randn(2, 4, llama.d_model).bfloat16()
    jobs = [dict(kind="staged", name="staged", mesh=dict(pod=2),
                 device="cpu", cfg=granite, stages=[0, 1], seed=0,
                 batch={"tokens": toks}, runs=[False, True]),
            dict(kind="moe", name="moe", mesh=dict(model=2), device="cpu",
                 cfg=llama, x=x, seed=1, w8a8=True),
            dict(kind="profile", name="profile", mesh=dict(pod=2),
                 device="cpu", cfg=granite, stages=[0, 1], seed=0,
                 batch={"tokens": toks}, runs=[False, True])]
    torch.save(jobs, tmp_path / "jobs.pt")
    path = os.pathsep.join([str(tmp_path / "poison"),
                            os.path.join(REPO, "src")])
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.launch.mesh import run_world; "
         "run_world(2, 'repro_torch.launch.collab:run_jobs', sys.argv[1], "
         "sys.argv[2])", str(tmp_path / "jobs.pt"), str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=path), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("staged", "moe", "profile"):
        for r in range(2):
            assert (tmp_path / f"{name}.{r}.pt").exists()
    d, v = granite.d_model, granite.vocab_size
    for r in range(2):
        raw, comp = torch.load(tmp_path / f"profile.{r}.pt",
                               weights_only=False)["runs"]
        assert raw["collective"]["collective-permute"] == 2 * 8 * d * 2
        assert comp["collective"]["collective-permute"] == 2 * 8 * (d + 4)
        for run in (raw, comp):
            assert run["collective"]["broadcast"] == 2 * 8 * v * 4
            assert run["flops"] > 0 and run["bytes"] > 0
        assert set(comp["kernels"]) == {"flash_attention", (
            "quantize_rows", "dequantize_rows")[r]}
