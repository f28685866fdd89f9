"""Gradient compression with error feedback and its packed wire codec.

Port of ``repro/core/compression.py``: the none, 1-bit (sign + per-block
mean-|x| scale), int8 and block-local top-k compressors, the
error-feedback round ``c = encode(g + r); r <- (g + r) - decode(c)``, the
narrowing of each compressor's wire to its true on-the-wire dtypes (8
signs per byte, bf16 scales, uint16 top-k indices), the uint8 packing of
those arrays into one buffer per bucket, the fused encode rounds that
``core/fabric.py`` dispatches to the kernels (``kernels/ops.py``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors), and the
leaf-wise error-feedback codec (``ef_compress_tree``, and DGC's momentum
correction ``dgc_compress_tree``) that a strategy of one's own may call.

The leaf-wise codec runs each leaf's round for the 1-bit and top-k
compressors as ONE kernel launch: ``ops.onebit_quant`` (t = g + r, int8
signs, f32 mean-|t| scale, residual) and ``ops.topk_sparsify`` on
t = g + r (values, indices and the dense kept entries, which are
``decompress(compress(t))``).  A leaf is folded as ``compress`` folds it:
flattened whole, replica axes included, its tail zero-padded to a block.
Every 1-bit and top-k round goes through ``ops``: the plain version for
a CPU tensor, the kernel for a CUDA tensor, which raises on a block it
does not take (nothing falls back to the codec).  The int8 and none
compressors run the codec's compress → decompress round.

Differences from the reference, none of which changes a result:
  * ``Compressor`` also records its ``block`` (and ``k`` for top-k), so
    ``packed_nbytes`` is a closed form instead of the reference's
    ``jax.eval_shape`` of the packing code (a test holds the two equal);
  * ``lax.top_k`` is a STABLE descending sort here (lowest index first on
    ties), which ``torch.topk`` does not promise;
  * the reference's ``_kernel_rows`` only sizes a Pallas grid and has no
    counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import tree as T


@dataclass(frozen=True)
class Compressor:
    name: str
    compress: Callable  # (x) -> (wire, meta)  [wire: what's transmitted]
    decompress: Callable  # (wire, meta, shape, dtype) -> x_hat
    wire_bits_per_element: float  # analytic bits/elem (see wire_bytes)
    # (g, r) flat f32 tensors of shape lead + (n,) -> (narrow_arrs, widen,
    # new_residual): the fused kernel encode+error-feedback round.
    # ``narrow_arrs`` match the _narrow_wire output for compress(g + r)
    # byte for byte; ``widen(arrs)`` maps ONE replica's narrow arrays back
    # to what ``decompress`` expects.  None -> no fused path.
    fused_encode: Optional[Callable] = None
    block: int = 0  # elements per compression block (0: no blocks)
    k: int = 0  # top-k: entries kept per block


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------
def none_compressor() -> Compressor:
    return Compressor(
        name="none",
        compress=lambda x: (x, None),
        decompress=lambda w, m, shape, dtype: w,
        wire_bits_per_element=32.0,
    )


def _blocks(x, block):
    """x flattened to f32 (nb, block) rows, the tail zero-padded (a view of
    a contiguous f32 x that fills whole blocks)."""
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % block
    return (F.pad(flat, (0, pad)) if pad else flat).reshape(-1, block)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


# ---------------------------------------------------------------------------
# 1-bit quantization (sign + per-block mean-|x| scale)
# ---------------------------------------------------------------------------
def onebit_compressor(block: int = 256) -> Compressor:
    def compress(x):
        blocks = _blocks(x, block)
        sign = torch.where(blocks >= 0, 1.0, -1.0)
        scale = blocks.abs().sum(dim=-1, keepdim=True) / block  # jnp.mean
        return (sign.to(torch.int8), scale), None

    def decompress(wire, meta, shape, dtype):
        sign, scale = wire
        flat = (sign.float() * scale).reshape(-1)[:_numel(shape)]
        return flat.reshape(shape).to(dtype)

    # 1 bit per element + one fp32 scale per block
    return Compressor("onebit", compress, decompress,
                      wire_bits_per_element=1.0 + 32.0 / block,
                      fused_encode=(_fused_onebit(block)
                                    if block % 8 == 0 else None),
                      block=block)


# ---------------------------------------------------------------------------
# int8 linear quantization (per-block max-abs scale)
# ---------------------------------------------------------------------------
def int8_compressor(block: int = 256) -> Compressor:
    def compress(x):
        blocks = _blocks(x, block)
        scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
        q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-30)),
                        -127, 127)
        return (q.to(torch.int8), scale), None

    def decompress(wire, meta, shape, dtype):
        q, scale = wire
        flat = (q.float() * scale).reshape(-1)[:_numel(shape)]
        return flat.reshape(shape).to(dtype)

    return Compressor("int8", compress, decompress,
                      wire_bits_per_element=8.0 + 32.0 / block, block=block)


# ---------------------------------------------------------------------------
# block-local top-k sparsification (DGC-style)
# ---------------------------------------------------------------------------
def topk_compressor(ratio: float = 0.01, block: int = 1024) -> Compressor:
    if block > 1 << 16:
        raise ValueError(  # the packed wire format uses uint16 indices
            f"topk block must be <= 65536 (got {block}); in-block indices "
            "are shipped as uint16 (core/fabric.py)")
    k = max(1, int(round(block * ratio)))

    def compress(x):
        blocks = _blocks(x, block)
        # lax.top_k: descending, lowest index first among equal magnitudes
        idx = torch.sort(blocks.abs(), dim=-1, descending=True,
                         stable=True).indices[:, :k]
        taken = torch.gather(blocks, 1, idx)
        return (taken, idx.to(torch.int32)), None

    def decompress(wire, meta, shape, dtype):
        taken, idx = wire
        nblocks = idx.shape[0]
        blocks = torch.zeros((nblocks, block), dtype=torch.float32,
                             device=taken.device)
        blocks.scatter_(1, idx.long(), taken)
        return blocks.reshape(-1)[:_numel(shape)].reshape(shape).to(dtype)

    # k values (32b) + k indices (16b suffices for block <= 64k) per block
    return Compressor(f"topk{ratio}", compress, decompress,
                      wire_bits_per_element=ratio * (32.0 + 16.0),
                      fused_encode=_fused_topk(k, block), block=block, k=k)


# ---------------------------------------------------------------------------
# fused kernel encode+error-feedback rounds (the production Fabric path)
# ---------------------------------------------------------------------------
def _fold_blocks(g, r, block: int):
    """lead + (n,) f32 pair → (rows, block) kernel inputs.  Replica lead
    axes fold into kernel rows AFTER per-replica zero-padding to a block
    multiple, so a compression block never mixes values from two
    replicas."""
    n = g.shape[-1]
    pad = (-n) % block
    g2 = g.float().reshape(-1, n)
    r2 = r.float().reshape(-1, n)
    if pad:
        g2 = F.pad(g2, (0, pad))
        r2 = F.pad(r2, (0, pad))
    nb = (n + pad) // block
    rows = g2.shape[0] * nb
    return (g2.reshape(rows, block).contiguous(),
            r2.reshape(rows, block).contiguous(), nb, pad)


def _unfold_residual(newr, lead, n: int, pad: int):
    """Kernel residual rows → lead + (n,) (padded tail dropped)."""
    return newr.reshape(-1, n + pad)[:, :n].reshape(tuple(lead) + (n,))


def _fused_onebit(block: int):
    def fused_encode(g, r):
        from repro_torch.kernels import ops

        lead, n = tuple(g.shape[:-1]), g.shape[-1]
        gb, rb, nb, pad = _fold_blocks(g, r, block)
        packed, scale, newr = ops.onebit_quant_packed(gb, rb)
        arrs = [packed.reshape(lead + (nb * (block // 8),)),
                scale.reshape(lead + (nb, 1))]

        def widen(a):  # one replica's narrow arrays → decompress wire
            p, s = a
            sign = unpack_signs(p.reshape(-1), nb * block)
            return sign.reshape(nb, block), s.float()

        return arrs, widen, _unfold_residual(newr, lead, n, pad)

    return fused_encode


def _fused_topk(k: int, block: int):
    def fused_encode(g, r):
        from repro_torch.kernels import ops

        lead, n = tuple(g.shape[:-1]), g.shape[-1]
        gb, rb, nb, pad = _fold_blocks(g, r, block)
        vals, idx, newr = ops.topk_encode_ef(gb, rb, k)
        arrs = [vals.reshape(lead + (nb, k)),
                idx.to(torch.uint16).reshape(lead + (nb, k))]

        def widen(a):
            return a[0], a[1].to(torch.int32)

        return arrs, widen, _unfold_residual(newr, lead, n, pad)

    return fused_encode


REGISTRY = {
    "none": none_compressor,
    "onebit": onebit_compressor,
    "int8": int8_compressor,
    "topk": topk_compressor,
}


def get_compressor(name: str, **kw) -> Compressor:
    return REGISTRY[name](**kw)


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------
def ef_init(params):
    """Error-feedback residual state (one per communicated leaf)."""
    return T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)


def _leaf_round(comp: Compressor, g, r):
    """One error-feedback round of one leaf: (decoded g_hat f32 of g's
    shape, new residual) with g_hat = decompress(compress(g + r)).  1-bit
    and top-k run it as one kernel launch on the leaf folded into
    ``(nb, block)`` rows (the plain version for CPU tensors; on the card
    the kernel raises on a block it does not take); none and int8 run the
    codec."""
    from repro_torch.kernels import ops

    if comp.name == "onebit":  # the kernel forms t = g + r itself
        sign, scale, new_r = ops.onebit_quant(_blocks(g, comp.block),
                                              _blocks(r, comp.block))
        dec = sign.float() * scale
    elif comp.name.startswith("topk"):
        t = _blocks(g, comp.block) + _blocks(r, comp.block)
        dec = ops.topk_sparsify(t, comp.k)[2]
        new_r = t - dec
    else:
        target = g.float() + r
        wire, meta = comp.compress(target)
        g_hat = comp.decompress(wire, meta, tuple(g.shape), torch.float32)
        return g_hat, target - g_hat
    n = g.numel()
    return (dec.reshape(-1)[:n].reshape(g.shape),
            new_r.reshape(-1)[:n].reshape(g.shape))


def ef_compress_tree(comp: Compressor, grads, residual):
    """Apply the compressor with error feedback leaf-wise.  Returns
    (g_hat, new_residual): ``g_hat`` is what gets communicated (already
    decompressed), the residual carries the compression error on.  One
    kernel launch a leaf for 1-bit and top-k."""

    def one(g, r):
        g_hat, new_r = _leaf_round(comp, g, r)
        return g_hat.to(g.dtype), new_r

    flat_g, tdef = T.flatten(grads)
    out = [one(g, r) for g, r in zip(flat_g, T.leaves(residual))]
    return (T.unflatten(tdef, [o[0] for o in out]),
            T.unflatten(tdef, [o[1] for o in out]))


def wire_bytes(comp: Compressor, tree) -> float:
    """EXACT bytes on the wire to ship ``tree`` once under ``comp``, each
    leaf compressed on its own (padded tail blocks charged)."""
    return float(sum(packed_nbytes(comp, x.numel()) for x in T.leaves(tree)))


# ---------------------------------------------------------------------------
# Deep Gradient Compression momentum correction (Lin et al.): accumulate
# MOMENTUM (not raw gradients) into the residual before compressing, so
# velocity that was not sent keeps accumulating instead of being lost.
# ---------------------------------------------------------------------------
def dgc_init(params):
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"velocity": T.tree_map(z, params),
            "residual": T.tree_map(z, params)}


def dgc_compress_tree(comp: Compressor, grads, state, momentum: float = 0.9):
    """Returns (g_hat, new_state): g_hat is the communicated (decompressed)
    velocity; velocity and residual carry what was not sent.  One kernel
    launch a leaf for 1-bit and top-k."""

    def one(g, u, r):
        u1 = momentum * u + g.float()
        # the round of target = r + u1 (f32 addition commutes bit for bit)
        sent, new_r = _leaf_round(comp, u1, r)
        # what was sent leaves both accumulators: u1 * (1 - mask), mask =
        # sent != 0, is u1 times (sent == 0) bit for bit
        return sent.to(g.dtype), u1 * (sent == 0), new_r

    flat_g, tdef = T.flatten(grads)
    outs = [one(g, u, r) for g, u, r in zip(
        flat_g, T.leaves(state["velocity"]), T.leaves(state["residual"]))]
    return (T.unflatten(tdef, [o[0] for o in outs]),
            {"velocity": T.unflatten(tdef, [o[1] for o in outs]),
             "residual": T.unflatten(tdef, [o[2] for o in outs])})


_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_signs(sign_int8):
    """Pack 8 int8 signs into one uint8, bit i%8 of byte i//8."""
    bits = (sign_int8 > 0).to(torch.uint8).reshape(-1, 8)
    w = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits * w).sum(dim=-1).to(torch.uint8)


def unpack_signs(packed, n):
    w = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] & w) > 0
    return bits.reshape(-1)[:n].to(torch.int8) * 2 - 1  # stays int8


# ---------------------------------------------------------------------------
# wire codecs: compressor wire tuple <-> one packed uint8 buffer
# ---------------------------------------------------------------------------
def _to_bytes(x):
    """Any tensor → flat uint8 view (little-endian, as the reference's
    bitcast)."""
    if x.dtype == torch.uint8:
        return x.reshape(-1)
    return x.contiguous().view(torch.uint8).reshape(-1)


def _from_bytes(buf, shape, dtype):
    shape = tuple(shape)
    seg = buf.clone()  # a fresh buffer: dtype views need an aligned offset
    if dtype == torch.uint8:
        return seg.reshape(shape)
    return seg.view(dtype).reshape(shape)


def _narrow_wire(name: str, wire):
    """Narrow a compressor's wire tuple to its true on-the-wire dtypes.
    Returns (arrays, widen); ``widen`` maps the narrowed arrays back to
    what ``Compressor.decompress`` expects.  Unknown compressors fall
    through to an identity codec."""
    if name == "onebit":
        sign, scale = wire
        n = sign.numel()
        flat = sign.reshape(-1)
        pad = (-n) % 8
        if pad:
            flat = torch.cat([flat, torch.ones(pad, dtype=flat.dtype,
                                               device=flat.device)])
        packed = pack_signs(flat)

        def widen(arrs):
            p, s = arrs
            return unpack_signs(p, n).reshape(sign.shape), s.float()

        return [packed, scale.to(torch.bfloat16)], widen
    if name == "int8":
        q, scale = wire

        def widen(arrs):
            return arrs[0], arrs[1].float()

        return [q, scale.to(torch.bfloat16)], widen
    if name.startswith("topk"):
        taken, idx = wire  # blocks <= 64k ⇒ uint16 indices

        def widen(arrs):
            return arrs[0], arrs[1].to(torch.int32)

        return [taken, idx.to(torch.uint16)], widen
    arrs, tdef = T.flatten(wire)
    return arrs, lambda a: T.unflatten(tdef, list(a))


def _pack(arrs):
    """Tensors → (uint8 buffer, segment specs)."""
    bufs = [_to_bytes(a) for a in arrs]
    specs = [(tuple(a.shape), a.dtype, b.shape[-1])
             for a, b in zip(arrs, bufs)]
    buf = bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=-1)
    return buf, specs


def _unpack(buf, specs):
    out, off = [], 0
    for shape, dtype, nb in specs:
        out.append(_from_bytes(buf[..., off:off + nb], shape, dtype))
        off += nb
    return out


def packed_nbytes(comp: Optional[Compressor], n: int) -> int:
    """Exact packed-wire bytes to ship ``n`` f32 elements once under
    ``comp``: the size of the uint8 buffer ``_pack`` builds, padded tail
    blocks included, in closed form."""
    if comp is None or comp.name == "none":
        return 4 * n
    nb = -(-n // comp.block)
    if comp.name == "onebit":  # signs padded to whole bytes + bf16 scales
        return -(-(nb * comp.block) // 8) + 2 * nb
    if comp.name == "int8":  # int8 codes + bf16 scales
        return nb * comp.block + 2 * nb
    if comp.name.startswith("topk"):  # f32 values + uint16 indices
        return 6 * comp.k * nb
    raise ValueError(f"packed_nbytes: no wire format for {comp.name!r}")
