"""1-bit quantization with error feedback, emitting the packed wire format.

Port of ``repro/kernels/onebit_quant.py::onebit_quant_packed`` (the Pallas
TPU kernel on the Fabric's default compressed path).  One fused round per
row of a flat f32 bucket folded into ``(nb, block)`` rows:

    t = g + r
    packed  bit i%8 of byte i//8 = (t_i >= 0)      (nb, block/8) uint8
    scale   bf16(mean |t|)                          (nb, 1) bfloat16
    new_r   t − sign·f32(scale)                     (nb, block) f32

``-0.0 >= 0`` holds, so a negative zero packs as +1, as in the reference.
The residual is taken against the ROUNDED scale, the one the receivers
decode with.

``onebit_quant_packed`` launches the CUDA kernel (``csrc/onebit_quant.cu``)
and counts its launches in ``onebit_quant_packed.launches``;
``onebit_quant_packed_plain`` is the plain PyTorch version.
``kernels.ops.onebit_quant_packed`` picks between them by the tensors'
device.
"""

from __future__ import annotations

import ctypes

import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def onebit_quant_packed_plain(g, r):
    """g, r: (nb, block) f32 → (packed (nb, block//8) uint8,
    scale (nb, 1) bf16, new_r (nb, block) f32), as the kernel body."""
    nb, block = g.shape
    if block % 8:
        raise ValueError(f"packed onebit needs block % 8 == 0, got {block}")
    t = g.float() + r
    bits = (t >= 0).to(torch.uint8).reshape(nb, block // 8, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=t.device)
    packed = (bits * w).sum(dim=-1).to(torch.uint8)
    # mean as sum / n, the order jnp.mean divides in
    scale = (t.abs().sum(dim=-1, keepdim=True) / block).to(torch.bfloat16)
    sign = torch.where(t >= 0, 1.0, -1.0)
    return packed, scale, t - sign * scale.float()


# the C prototype of onebit_quant_packed_fwd in csrc/onebit_quant.cu:
# g, r, packed, scale, new_r; rows; block; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p])


def _kernel_fn():
    from repro_torch.kernels import _build

    fn = _build.load("onebit_quant").onebit_quant_packed_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(g, r):
    for name, t in (("g", g), ("r", r)):
        if t.device.type != "cuda":
            raise ValueError(f"onebit_quant_packed: {name} is on {t.device}; "
                             "the kernel takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise ValueError(f"onebit_quant_packed: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"onebit_quant_packed: {name} must be contiguous "
                             "and 16-byte aligned (the kernel reads float4)")
    if g.device != r.device or g.shape != r.shape or g.dim() != 2:
        raise ValueError(f"onebit_quant_packed: g{tuple(g.shape)} on "
                         f"{g.device} and r{tuple(r.shape)} on {r.device} "
                         "must be one (nb, block) shape on one device")
    nb, block = g.shape
    if nb < 1 or block < 8 or block % 8:
        raise ValueError(f"onebit_quant_packed: needs nb >= 1 and block a "
                         f"positive multiple of 8, got ({nb}, {block})")


def onebit_quant_packed(g, r):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take)."""
    _check(g, r)
    nb, block = g.shape
    packed = torch.empty((nb, block // 8), dtype=torch.uint8, device=g.device)
    scale = torch.empty((nb, 1), dtype=torch.bfloat16, device=g.device)
    new_r = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(g.data_ptr(), r.data_ptr(), packed.data_ptr(),
                           scale.data_ptr(), new_r.data_ptr(), nb, block,
                           stream)
    if err:
        raise RuntimeError(f"onebit_quant_packed kernel launch failed: CUDA "
                           f"error {err}")
    onebit_quant_packed.launches += 1
    return packed, scale, new_r


onebit_quant_packed.launches = 0
