"""End-to-end mixed-precision policy.

Port of ``repro/core/precision.py``; the port keeps its own copy because
the reference module imports JAX.  A ``PrecisionPolicy`` names the dtype
of every float in the system:

    param_dtype    the working model weights (what forward consumes and the
                   fabric mixes on the wire)
    compute_dtype  matmul/activation compute inside the models (loss,
                   softmax and norm statistics always accumulate in f32)
    wire_dtype     uncompressed exchange buffers on the Fabric (2 bytes an
                   element under bf16; the compressors own their packed
                   wire format and ignore it)
    master_dtype   the optimizer's master copy of the weights: when it is
                   wider than ``param_dtype`` the train state keeps a
                   persistent master tree

plus dynamic loss scaling: the loss is multiplied by ``scale`` before the
backward pass, gradients are unscaled in f32, and a step whose gradients
hold an inf or a nan is SKIPPED (params, master, optimizer state and comm
state untouched) while the scale is halved; after ``growth_interval``
consecutive finite steps the scale doubles.

The ``f32`` policy is a strict no-op: it scales nothing, keeps no master
and casts nothing, so the train step computes the policy-less update
bitwise.  ``torch_dtype`` and ``ALLOWED_DTYPES``
serve the configs and the serving path as before.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import tree as T

ALLOWED_DTYPES = ("float32", "bfloat16", "float16")

_TORCH = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,  # KV page pools only
}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``) or a ``torch.dtype`` as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _TORCH:
        raise ValueError(f"unsupported dtype {dtype!r}; choose one of "
                         f"{sorted(_TORCH)}")
    return _TORCH[dtype]


def _check_dtype(name: str, value: str):
    if value not in ALLOWED_DTYPES:
        raise ValueError(
            f"{name}={value!r} is not a supported precision dtype; "
            f"choose one of {ALLOWED_DTYPES}")


@dataclass(frozen=True)
class PrecisionPolicy:
    name: str = "f32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    wire_dtype: str = "float32"
    master_dtype: str = "float32"
    init_loss_scale: float = 1.0
    dynamic_scale: bool = False
    growth_interval: int = 200

    def __post_init__(self):
        for f in ("param_dtype", "compute_dtype", "wire_dtype",
                  "master_dtype"):
            _check_dtype(f, getattr(self, f))

    # -- dtype accessors ----------------------------------------------------
    @property
    def param_dt(self) -> torch.dtype:
        return _TORCH[self.param_dtype]

    @property
    def compute_dt(self) -> torch.dtype:
        return _TORCH[self.compute_dtype]

    @property
    def wire_dt(self) -> torch.dtype:
        return _TORCH[self.wire_dtype]

    @property
    def master_dt(self) -> torch.dtype:
        return _TORCH[self.master_dtype]

    # -- behaviour flags ----------------------------------------------------
    @property
    def uses_scaling(self) -> bool:
        return self.dynamic_scale or self.init_loss_scale != 1.0

    @property
    def keeps_master(self) -> bool:
        """A persistent wider master copy of the params is required."""
        return self.master_dt != self.param_dt

    @property
    def narrow_wire(self) -> bool:
        """Uncompressed exchange buffers ship at 2 bytes an element."""
        return self.wire_dt.itemsize == 2

    @property
    def is_noop(self) -> bool:
        """True when the policy changes nothing against policy-less f32."""
        f32 = torch.float32
        return (self.param_dt == f32 and self.compute_dt == f32
                and self.wire_dt == f32 and self.master_dt == f32
                and not self.uses_scaling)

    # -- tree casts (float leaves only; identity when dtypes match) ---------
    def cast_to_param(self, tree):
        return cast_floats(tree, self.param_dt)

    def cast_to_compute(self, tree):
        return cast_floats(tree, self.compute_dt)

    def cast_to_master(self, tree):
        return cast_floats(tree, self.master_dt)

    # -- serialization (checkpoint meta) ------------------------------------
    def spec(self) -> dict:
        return dataclasses.asdict(self)


def policy_from_spec(spec: dict) -> PrecisionPolicy:
    return PrecisionPolicy(**spec)


def cast_floats(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype`` (ints untouched; a
    leaf already of ``dtype`` is returned as it is, not copied)."""
    dtype = torch_dtype(dtype)
    return T.tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


POLICIES = {
    # pure f32: the bitwise-identical default
    "f32": PrecisionPolicy("f32"),
    # mixed bf16: bf16 weights/compute/wire, f32 master and dynamic
    # scaling.  The initial scale is a power of two, so scaling never
    # perturbs a bf16 mantissa; it only guards true overflow.
    "bf16": PrecisionPolicy(
        "bf16", param_dtype="bfloat16", compute_dtype="bfloat16",
        wire_dtype="bfloat16", master_dtype="float32",
        init_loss_scale=float(2 ** 15), dynamic_scale=True),
    # pure bf16: no master, no scaling: least memory, lowest fidelity
    "bf16-pure": PrecisionPolicy(
        "bf16-pure", param_dtype="bfloat16", compute_dtype="bfloat16",
        wire_dtype="bfloat16", master_dtype="bfloat16"),
}


def get_policy(policy) -> PrecisionPolicy:
    """None → f32; a name → registry lookup; a policy → itself."""
    if policy is None:
        return POLICIES["f32"]
    if isinstance(policy, PrecisionPolicy):
        return policy
    if policy not in POLICIES:
        raise KeyError(f"unknown precision policy {policy!r}; "
                       f"have {sorted(POLICIES)}")
    return POLICIES[policy]


def apply_policy(cfg, policy):
    """ModelConfig with the policy's param/compute dtypes applied."""
    policy = get_policy(policy)
    return dataclasses.replace(cfg, param_dtype=policy.param_dtype,
                               compute_dtype=policy.compute_dtype)


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------
def init_scale_state(policy: PrecisionPolicy, device=None) -> dict:
    """Loss-scale carry: {"scale" f32, "good_steps" int32} scalars."""
    return {"scale": torch.full((), policy.init_loss_scale,
                                dtype=torch.float32, device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def unscale_grads(grads, scale):
    """Gradients → f32, times the reciprocal of the loss scale (the
    reference's order: ``g * (1 / scale)``)."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    inv = 1.0 / scale
    return T.tree_map(lambda g: g.float() * inv.to(g.device), grads)


def tree_finite(tree) -> torch.Tensor:
    """Scalar bool tensor: every element of every leaf is finite."""
    flags = [torch.isfinite(x).all() for x in T.leaves(tree)]
    return torch.stack(flags).all() if flags else torch.tensor(True)


def tree_finite_across(tree, comm=None) -> torch.Tensor:
    """``tree_finite`` of this rank's tree, MIN-reduced over the ranks of a
    per-rank comm (one with ``all_min``: ``core/comm.py::ShardComm``), as
    the reference's ``pmin``: every rank then takes the same skip
    decision.  A stacked comm's tree already holds every replica."""
    flag = tree_finite(tree)
    if comm is None or not hasattr(comm, "all_min"):
        return flag
    return comm.all_min(flag.float()) > 0.5


def next_scale_state(policy: PrecisionPolicy, sstate: dict, finite) -> dict:
    """Overflow → halve (never below 1) and reset the streak; a finite
    step extends the streak and every ``growth_interval``-th doubles."""
    scale, good = sstate["scale"], sstate["good_steps"]
    finite = torch.as_tensor(finite, device=scale.device)
    if not policy.dynamic_scale:  # static scale: still skip, never adapt
        return {"scale": scale,
                "good_steps": torch.where(finite, good + 1,
                                          torch.zeros_like(good))}
    grow = finite & (good + 1 >= policy.growth_interval)
    new_scale = torch.where(
        finite, torch.where(grow, scale * 2.0, scale),
        torch.clamp(scale * 0.5, min=1.0))
    new_good = torch.where(finite & ~grow, good + 1, torch.zeros_like(good))
    return {"scale": new_scale, "good_steps": new_good}


def select_tree(pred, on_true, on_false):
    """Elementwise where over two same-structure trees."""
    return T.tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)
