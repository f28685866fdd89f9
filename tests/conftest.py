import jax
import pytest

# Smoke tests and benches see the single real CPU device; ONLY the dry-run
# (launch/dryrun.py) sets xla_force_host_platform_device_count.
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "bf16: strategy-equivalence sweep under the bf16 precision policy "
        "(CI runs `pytest -m bf16` as its own job; the marks also run in "
        "the plain tier-1 sweep)")
    config.addinivalue_line(
        "markers",
        "accum: microbatched-train-step sweep (gradient accumulation, "
        "donation, prefetch — DESIGN.md §8); CI runs `pytest -m accum` as "
        "its own matrix entry, and the marks also run in plain tier-1")
    config.addinivalue_line(
        "markers",
        "serving: paged KV cache / paged-attention serving tier "
        "(DESIGN.md §10); CI runs `pytest -m serving` as its own matrix "
        "entry, and the marks also run in plain tier-1")
    config.addinivalue_line(
        "markers",
        "lint: static-analysis linter tier (repro.analysis, DESIGN.md "
        "§11) — rule positives/negatives, report-schema validation and "
        "the LINT.json artifact check; CI runs `pytest -m lint` as its "
        "own matrix entry, and the marks also run in plain tier-1")
    config.addinivalue_line(
        "markers",
        "tp: tensor-parallelism tier (models/tensor_parallel.py, "
        "DESIGN.md §12) — split/unsplit round-trip, bitwise forward and "
        "sub-layer backward vs the blocked reference, the \"tp\" "
        "collective contract and its HLO budget; CI runs `pytest -m tp` "
        "as its own matrix entry, and the marks also run in plain tier-1")
    config.addinivalue_line(
        "markers",
        "chaos: elastic fault-tolerance tier (launch/elastic.py, "
        "core/chaos.py, DESIGN.md §13) — fleet-view membership, bitwise "
        "in-memory ZeRO re-partitioning vs the checkpoint round-trip, "
        "straggler demotion/promotion, and the seeded chaos controller "
        "runs; CI runs `pytest -m chaos` as its own matrix entry, and "
        "the marks also run in plain tier-1")
    config.addinivalue_line(
        "markers",
        "torch: PyTorch port tier (src/repro_torch, tests/test_torch_*.py) "
        "— the port held against the JAX package on the CPU; the few "
        "tests that need a CUDA card skip without one, with a reason")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
