"""The port stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package, and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import _build
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import PagedDecodeEngine

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    assert len(MODULES) >= 12


RANK_PROGRAMS = ["tests/_torch_ranks.py", "tests/_torch_model_ranks.py",
                 "tests/_torch_axis_ranks.py", "tests/_torch_lint_ranks.py"]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"] + RANK_PROGRAMS))
def test_sources_import_no_jax_and_nothing_of_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_rank_programs_pull_in_no_jax():
    """The rank processes' programs (and so every module they reach) load
    no JAX and nothing of the JAX package."""
    code = ("import sys\n"
            "import _torch_ranks, _torch_model_ranks, _torch_axis_ranks\n"
            "import _torch_lint_ranks\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("module,path", [
    ("repro_torch.core.comm", "src/repro_torch/core/comm.py"),
    ("repro_torch.launch.mesh", "src/repro_torch/launch/mesh.py"),
    ("repro_torch.models.tensor_parallel",
     "src/repro_torch/models/tensor_parallel.py"),
    ("repro_torch.train.loop", "src/repro_torch/train/loop.py")])
def test_multiprocess_modules_take_torch_distributed_never_jax(module, path):
    """The per-rank comm, the mesh and launcher, and the sharded step are
    in the import check above; ``torch.distributed`` is theirs to use."""
    assert module in MODULES
    names = _imports(path)
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                   for n in names), names
    if module not in ("repro_torch.train.loop",
                      "repro_torch.models.tensor_parallel"):
        assert any(n.startswith("torch.distributed")
                   or n == "torch.multiprocessing" for n in names), names


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              num_layers=1, d_model=32, vocab_size=32)
    params = TT.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        PagedDecodeEngine(params, cfg, batch_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TT.init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TT.init_paged_cache(cfg, num_pages=2, page_size=4)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc, no kernel: the build raises rather than falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention")
    assert not (tmp_path / "build").exists()


def test_build_targets_sm90a_and_every_source():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) \
        == ["flash_attention", "fused_adam", "mamba_scan", "mamba_scan_bwd",
            "onebit_quant", "paged_attention", "topk_sparsify"]


@pytest.mark.parametrize("name", ["qwen2-1.5b", "gemma3-1b", "qwen2.5-14b",
                                  "jamba-1.5-large-398b", "xlstm-125m",
                                  "deepseek-67b", "granite-moe-1b-a400m",
                                  "qwen2-moe-a2.7b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_configs_copy_the_reference_field_for_field(name):
    ours, ref = get_config(name), jax_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) \
        == dataclasses.asdict(ref.reduced())
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.resolved_head_dim == ref.resolved_head_dim
    assert ours.expert_d_ff == ref.expert_d_ff
    assert ours.num_experts_padded == ref.num_experts_padded
    for cfg_o, cfg_r in ((ours, ref), (ours.reduced(), ref.reduced())):
        (specs_o, rep_o), (specs_r, rep_r) = (cfg_o.superblock(),
                                              cfg_r.superblock())
        assert rep_o == rep_r
        assert [dataclasses.asdict(x) for x in specs_o] \
            == [dataclasses.asdict(x) for x in specs_r]
    for a, b in zip(ours.layer_windows(), ref.layer_windows()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("member", ["expert_d_ff", "num_experts_padded",
                                    "superblock", "layer_windows", "reduced",
                                    "param_count", "active_param_count"])
def test_config_members_are_the_reference_source(member):
    """The copied ``ModelConfig``'s MoE sizing and stack layout are the
    reference's code, byte for byte."""
    import inspect

    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro_torch.configs.base import ModelConfig

    def source(cls):
        m = getattr(cls, member)
        return inspect.getsource(m.fget if isinstance(m, property) else m)

    assert source(ModelConfig) == source(JaxModelConfig)


def test_config_registry_and_dtype_check():
    from repro.configs import list_configs as jax_list_configs

    assert list_configs() == ["deepseek-67b", "gemma3-1b",
                              "granite-moe-1b-a400m", "jamba-1.5-large-398b",
                              "pixtral-12b", "qwen2-1.5b", "qwen2-moe-a2.7b",
                              "qwen2.5-14b", "seamless-m4t-medium",
                              "xlstm-125m"]
    assert list_configs() == jax_list_configs()
    with pytest.raises(KeyError):
        get_config("llama-7b")
    with pytest.raises(ValueError, match="supported precision"):
        dataclasses.replace(get_config("qwen2-1.5b"), param_dtype="int4")


def test_qwen25_14b_reduced_tree_round_trips_bitwise():
    """The reduced qwen2.5-14b (untied lm_head, GQA 4:4 once reduced) in
    the reference's tree layout, through the bridge and back."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.bridge import params_to_numpy

    cfg = get_config("qwen2.5-14b").reduced()
    ours = TT.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jax_config(
        "qwen2.5-14b").reduced()), jax.random.PRNGKey(0))
    tree = params_to_numpy(ours)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    assert "lm_head" in tree
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "pixtral-12b"])
def test_encdec_and_vision_reduced_trees_round_trip_bitwise(name):
    """seamless's encoder subtree (one layer's dict stacked over the
    encoder layers) and cross leaves, and pixtral's untied head, in the
    reference's tree layout, through the bridge and back: a pure copy."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.bridge import params_to_numpy

    cfg = get_config(name).reduced()
    ours = TT.init_model(torch.Generator().manual_seed(2), cfg, "cpu")
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jax_config(
        name).reduced()), jax.random.PRNGKey(0))
    tree = params_to_numpy(ours)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    assert ("encoder" in tree) == cfg.is_encoder_decoder
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_deepseek_67b_reduced_tree_round_trips_bitwise():
    """deepseek-67b (untied lm_head, GQA 64:8; 4:4 once reduced) in the
    reference's tree layout, through the bridge and back."""
    import jax

    from repro.models import transformer as JT
    from repro_torch.bridge import params_to_numpy

    cfg = get_config("deepseek-67b").reduced()
    ours = TT.init_model(torch.Generator().manual_seed(1), cfg, "cpu")
    shapes = jax.eval_shape(lambda k: JT.init_model(k, jax_config(
        "deepseek-67b").reduced()), jax.random.PRNGKey(0))
    tree = params_to_numpy(ours)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    assert "lm_head" in tree
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("module", ["consistency", "staleness"])
def test_numpy_copies_import_nothing_of_repro(module):
    """The port's copies of the reference's numpy-only modules import
    numpy and the standard library only."""
    tree = ast.parse((PORT / "core" / f"{module}.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "dataclasses", "typing", "numpy"}, tops


@pytest.mark.parametrize("path", ["core/resharding.py",
                                  "checkpoint/checkpointer.py",
                                  "checkpoint/__init__.py",
                                  "examples/train_lm.py"])
def test_slice_modules_import_no_jax_and_nothing_of_repro(path):
    """The checkpointer and the re-sharding copy (the reference's are
    numpy) import numpy, torch, the standard library and the port only;
    so does the ``train_lm`` example."""
    tree = ast.parse((PORT / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "argparse", "json", "math", "os", "re",
                    "time", "warnings", "zlib", "numpy", "torch",
                    "repro_torch"}, tops


def test_train_lm_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from repro_torch.examples import train_lm

    with pytest.raises(RuntimeError, match="cuda.is_available"):
        train_lm.main(["--steps", "1"])


def _import_tops(path):
    tree = ast.parse((PORT / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", ["launch/elastic.py", "core/chaos.py",
                                  "examples/edge_async_sim.py"])
def test_elastic_modules_import_no_jax_and_nothing_of_repro(path):
    """The elastic fleet, the chaos harness and the edge example import
    numpy, torch, the standard library and the port only."""
    assert _import_tops(path) <= {"__future__", "argparse", "dataclasses",
                                  "time", "numpy", "torch",
                                  "repro_torch"}, path


def test_chaos_copy_imports_numpy_only():
    """``core/chaos.py`` copies the reference's numpy-only module."""
    assert _import_tops("core/chaos.py") <= {"__future__", "dataclasses",
                                             "numpy"}


def test_edge_async_sim_and_sample_batch_default_to_cuda():
    _no_cuda()
    from repro_torch.data.pipeline import DataConfig, sample_batch
    from repro_torch.examples import edge_async_sim

    with pytest.raises(RuntimeError, match="cuda.is_available"):
        edge_async_sim.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        sample_batch(DataConfig(vocab_size=8, seq_len=4,
                                batch_per_worker=1), 0, 0)


@pytest.mark.parametrize("path", ["analysis/__init__.py", "analysis/report.py",
                                  "analysis/rules.py", "analysis/rigs.py",
                                  "analysis/sweep.py", "launch/lint.py"])
def test_lint_tier_imports_no_jax_repro_or_benchmarks(path):
    """The lint tier keeps its own copies of the reference's validator
    helpers (``benchmarks/common.py``): it imports the standard library,
    numpy, torch and the port only."""
    assert ".".join(("repro_torch",) + Path(path).with_suffix("").parts) \
        .removesuffix(".__init__") in MODULES
    tree = ast.parse((PORT / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "argparse", "collections", "dataclasses",
                    "json", "math", "os", "sys", "time", "typing", "weakref",
                    "numpy", "torch", "repro_torch"}, tops
