#!/usr/bin/env python3
"""Time lane maps of the selective scan's backward kernel on one CUDA card.

    python3 scripts/mamba_scan_bwd_maps.py [--before PATH] [--sass-dir DIR]

A map is ``csrc/mamba_scan_bwd.cu`` with its lane-map constants
(``kLaneStates``, ``kChunk``, ``kWarps``, ``kMinWarps``) set to the values
in ``MAPS``; "tree" is the source as it stands.  All are built at once into
``build/kernels/bwd-map-<name>/``.  The tree's kernel is first held
against the plain version on ``chip_smoke.py``'s backward shapes
(``check_mamba_bwd``); every map is then held against it at jamba's scan
(bf16, B 1, L 2048, D 16384, N 16, B/C slices of x_proj's output) and on
a ragged f32 shape (D 200, L 1000): within ``MAMBA_BWD_TOL``, two calls
``torch.equal``.  The maps that pass are timed at jamba's scan in two
rounds, each map once a round (and ``--before``, an earlier design's
source, beside them): CUDA events around the wrapper and the profiler's
device time of the kernel, L2 flushed before each call.  One JSON line a
map (registers, spills, the SASS of its two loops a state-step, scratch
bytes, times), then the card's ``nvidia-smi`` name and power limit; with
``--sass-dir`` each map's two loops' SASS (bf16, N 16) go to
DIR/<map>.sass.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# each map's constants; the source's own are the "tree" entry
MAPS = {
    "s8_t8_w4_m8": {"kLaneStates": 8, "kChunk": 8, "kWarps": 4,
                    "kMinWarps": 8},
    "s8_t4_w4_m12": {"kLaneStates": 8, "kChunk": 4, "kWarps": 4,
                     "kMinWarps": 12},
    "s4_t8_w4_m16": {"kLaneStates": 4, "kChunk": 8, "kWarps": 4,
                     "kMinWarps": 16},
    "s4_t16_w4_m8": {"kLaneStates": 4, "kChunk": 16, "kWarps": 4,
                     "kMinWarps": 8},
}
RAGGED = (1, 1000, 200, 16)


def variant(text, consts):
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} is not one constexpr of the source")
    return text


def build_maps(before):
    """{name: (library, ptxas log, source text)}: the tree, each map and
    ``before``, built in parallel."""
    from repro_torch.kernels import _build

    tree = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    texts = {"tree": tree}
    texts.update({k: variant(tree, v) for k, v in MAPS.items()})
    srcs = {}
    for name, text in texts.items():
        out = _build.BUILD_ROOT / f"bwd-map-{name}"
        out.mkdir(parents=True, exist_ok=True)
        srcs[name] = out / "mamba_scan_bwd.cu"
        srcs[name].write_text(text)
    if before is not None:
        texts["before"] = Path(before).read_text()
        srcs["before"] = Path(before)
    with ThreadPoolExecutor(len(srcs)) as pool:
        done = {k: pool.submit(cs.build_source, v, f"bwd-map-{k}")
                for k, v in srcs.items()}
        return {k: (*f.result(), texts[k]) for k, f in done.items()}


def check_map(ms, built):
    """Max relative errors at jamba's shape (bf16) and on RAGGED (f32), or
    the failure's text."""
    lib, _, text = built
    out = {}
    try:
        with cs.scan_bwd_kernel(ms, lib, text):
            for (b, l, d, n), dt, r, seed in (
                    (cs.JAMBA_SCAN, torch.bfloat16, cs.JAMBA_DT_RANK, 70),
                    (RAGGED, torch.float32, 0, 71)):
                rng = np.random.default_rng(seed)
                args = cs.mamba_inputs(rng, b, l, d, n, dt, dt_rank=r)
                dy = cs.mamba_dy(rng, b, l, d, dt)
                out[f"{str(dt)[6:]} L={l} D={d}"] = cs.mamba_bwd_err(
                    ms, args, dy, "map check")[0]
    except AssertionError as e:
        return None, str(e)
    return out, None


def write_sass(path, lib, nvcc):
    """The SASS of the bf16, N = 16 kernel's loops with MUFU.EX2."""
    funcs = cs.sass_functions(lib, nvcc) or {}
    name = cs.scan_function(funcs, "mamba_scan_bwd_kernel")
    loops = cs.mufu_loops(funcs[name]) if name else []
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n\n".join("\n".join(f"/*{a:04x}*/ {t}" for a, t in body)
                                for _, _, body in loops))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", type=Path, default=None,
                        help="an earlier design's mamba_scan_bwd.cu, timed "
                             "beside the maps")
    parser.add_argument("--sass-dir", type=Path, default=None,
                        help="write each map's two loops (bf16, N 16) as "
                             "SASS text into this directory")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("mamba_scan_bwd_maps: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as ms

    smi = cs.nvidia_smi()
    built = build_maps(opts.before)
    with cs.scan_bwd_kernel(ms, built["tree"][0], built["tree"][2]):
        cs.emit(cs.check_mamba_bwd(ms))
    b, l, d, n = cs.JAMBA_SCAN
    rows = {}
    for name, (lib, log, text) in built.items():
        geo = cs.bwd_geometry(text)
        errs, fault = check_map(ms, built[name])
        if opts.sass_dir is not None:
            write_sass(opts.sass_dir / f"{name}.sass", lib, _build._nvcc())
        rows[name] = {
            "phase": "mamba_scan_bwd_map", "map": name,
            "constants": MAPS.get(name) or {
                k: int(v) for k, v in re.findall(
                    r"constexpr int (k\w+) = (\d+);", text)},
            "build": cs.bwd_build_stats(lib, log, _build._nvcc(), text),
            "partial_bytes": 4 * -(-d // geo["channels"](n)) * l * 2 * n,
            "checkpoint_bytes": 4 * -(-l // geo["chunk"]) * d * n,
            "max_rel_err": errs, "fault": fault, "ms_runs": [],
            "device_ms_runs": []}
    timed = [k for k, r in rows.items() if r["fault"] is None]
    rng = np.random.default_rng(10)
    args = cs.mamba_inputs(rng, b, l, d, n, torch.bfloat16,
                           dt_rank=cs.JAMBA_DT_RANK)
    dy = cs.mamba_dy(rng, b, l, d, torch.bfloat16)
    flush = cs.l2_flush()
    for _ in range(2):
        for name in timed:
            with cs.scan_bwd_kernel(ms, built[name][0], built[name][2]):
                def call():
                    return ms.mamba_scan_bwd(*args, dy)
                dev = cs.profiled_ms(call, 5, flush, "mamba_scan_bwd_kernel")
                rows[name]["device_ms_runs"].append(
                    sum(dev.values()) if dev else None)
                rows[name]["ms_runs"].append(cs.cuda_ms(call, 10, flush))
    for name, row in rows.items():
        dev = [x for x in row["device_ms_runs"] if x is not None]
        row["ms"] = statistics.mean(row["ms_runs"]) if row["ms_runs"] \
            else None
        row["device_ms"] = statistics.mean(dev) if dev else None
        row["card"] = smi
        cs.emit(row)
    print(smi, flush=True)
    return 0 if not any(r["fault"] for k, r in rows.items()
                        if k in ("tree", "before")) else 1


if __name__ == "__main__":
    sys.exit(main())
