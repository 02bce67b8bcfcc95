"""How much of the inference flash-attention kernel's time is its softmax?
(Port of tools/bench_softmax_floor.py to one CUDA card.)

At the encoder's embedded shape (B=24, H=8, T=1400, d=32, bf16, the TPU
tool's whole-row key blocks: block_k 1408) it times a ladder of stripped
variants of the inference kernel K1 (ops/attention_floor.py: K1's own
kernel, csrc/flash_forward.cuh, with the rung a compile-time mode) beside
K1 itself (ops/flash_attention.py, "full"):

  dots     the products alone: q·kᵀ then P·V, no softmax (wrong numerics)
  unsafe   + exp2 and the row sum, no running max and no corrections
  bf16sm   the full online softmax with its per-element chain in bf16
  full     the shipped kernel: online softmax, f32 chain, P as hi + lo

All four run the same tiles, staging and tensor-core products, so the gaps
are K1's own. It prints the gaps between the rungs in ms and as shares of
full (full - dots: what K1's softmax costs it, the hi + lo P included), and
the bf16 softmax's max |Δ| against full. The TPU tool's `bf16dot` row (full with
bf16 operands) has no counterpart: the port's kernel has no bf16-dot option.
Times are device time per call (utils/timing.py); inputs are made on the card
from seed 0.

Run on the card:   python -m future_od_tpu_torch.tools.bench_softmax_floor
On the CPU (tiny shapes, plain versions, no times):  ... --check
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from future_od_tpu_torch.ops.attention_floor import MODES, attention_floor
from future_od_tpu_torch.ops.flash_attention import flash_attention
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device
from future_od_tpu_torch.utils.timing import device_ms_chained

SHAPE = (24, 8, 1400, 32)  # B, H, T, d
BLOCK_K = 1408
CHECK_SHAPE, CHECK_BLOCK_K = (1, 2, 40, 32), 16  # 8 padded keys a row, as at full size


def run(shape=SHAPE, block_k: int = BLOCK_K, device: DeviceLike = None,
        dtype: torch.dtype = torch.bfloat16, timed: bool = True) -> dict:
    """Run the ladder; returns {"ms": {rung: ms or None}, "bf16sm_err": float}.
    `timed` False (the only choice on the CPU) checks and prints no times."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(shape[-1])
    rungs = {mode: (lambda a, m=mode: attention_floor(a, k, v, scale, m, block_k))
             for mode in MODES}
    rungs["full"] = lambda a: flash_attention(a, k, v, scale)
    print(f"== softmax floor {tuple(shape)} {dtype} block_k={block_k} on {device} ==", flush=True)
    ms, outs = {}, {}
    for name, fn in rungs.items():
        outs[name] = fn(q)
        if not bool(torch.isfinite(outs[name]).all()):
            raise AssertionError(f"{name}: non-finite output")
        ms[name] = device_ms_chained(fn, q) if timed else None
        shown = f"{ms[name]:.3f} ms" if timed else "(not timed)"
        print(f"{name:>10}: {shown}", flush=True)
    print(f"{'bf16dot':>10}: not ported (the port's flash kernel has no bf16-dot option)",
          flush=True)
    err = (outs["bf16sm"].float() - outs["full"].float()).abs().max().item()
    print(f"bf16-softmax max |Δ| vs shipped kernel: {err:.5f}", flush=True)
    if timed:
        for hi, lo in (("unsafe", "dots"), ("bf16sm", "unsafe"), ("full", "unsafe"),
                       ("full", "dots")):
            gap = ms[hi] - ms[lo]
            print(f"  {hi} - {lo}: {gap:.3f} ms = {gap / ms['full']:.1%} of full", flush=True)
        print(f"K1's softmax (full - dots): {(ms['full'] - ms['dots']) / ms['full']:.1%} of "
              "its time", flush=True)
    return {"ms": ms, "bf16sm_err": err}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="tiny shapes on the CPU through the plain versions, untimed")
    args = parser.parse_args(argv)
    if args.check:
        run(CHECK_SHAPE, CHECK_BLOCK_K, device="cpu", timed=False)
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
