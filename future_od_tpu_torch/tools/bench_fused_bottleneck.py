"""Fused-bottleneck kernel variants against the plain version at ResNet-50's
layer1-3 shapes, on one CUDA card. (Port of tools/bench_fused_bottleneck.py.)

Layer1 at a 896x1600 input is 3 bottlenecks at 224x400, cmid 64, cout 256.
At batch 12, bf16, it times and checks against the first row of each
section (relmax: max |Δ| over max |first|):

- layer1's inner block (cin 256) and block 0 (cin 64 with the downsample):
  `plain` (ops/fused_resnet.py::bottleneck_plain, where the TPU tool has
  XLA), the shipped kernel `fused v1` (fused_bottleneck), and the study
  kernel `fused_bottleneck_v2` over tile_h 8/16/32 x im2col 0/1;
- layer2 (112x200, 512/128) and layer3 (56x100, 1024/256) inner blocks:
  plain and v2 at tile 8 with im2col;
- all of layer1: plain, three fused v1 calls, three v2 calls, and
  `fused_layer1` (the three blocks chained in one kernel) at tile 8 and 16.

A v2 row names the column tile (tw) and the band rows (band) the kernel
chose and the 3x3's reduction rows a chain (chain: 9 cmid with im2col, cmid
for nine tap chains); a v3 row its column tile, its band and the operations
it does over those layer1 needs (halo recompute). Times are device time
per call (utils/timing.py); activations are made on the card from seed 0,
weights with numpy from seed 0 as the TPU tool makes them.

Run on the card:   python -m future_od_tpu_torch.tools.bench_fused_bottleneck
On the CPU (tiny shapes, plain versions, no times):  ... --check
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from future_od_tpu_torch.ops.fused_resnet import (
    bottleneck_plain,
    bottleneck_plan,
    fused_bottleneck,
    fused_bottleneck_v2,
    fused_layer1,
    layer1_plain,
    layer1_recompute,
)
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device
from future_od_tpu_torch.utils.jax_weights import blocks_from_numpy
from future_od_tpu_torch.utils.timing import device_ms_chained

BATCH, HEIGHT, WIDTH = 12, 224, 400
STAGES = {"layer2": (112, 200, 512, 128), "layer3": (56, 100, 1024, 256)}  # h, w, cin, cmid
TILES, V3_TILES = (8, 16, 32), (8, 16)
# --check: layer1 at 16x24 (two 8-row tiles), the other stages shrunk alike
CHECK = dict(batch=2, hw=(16, 24), stages={"layer2": (8, 12, 128, 32), "layer3": (8, 8, 128, 64)})


def make_layer1_blocks(rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """Layer1's three bottlenecks as the TPU tool makes them (numpy f32,
    N(0, 0.1^2), block 0 with a 64->256 downsample)."""
    r = lambda *s: rng.normal(size=s).astype(np.float32) * 0.1  # noqa: E731
    blocks = []
    for k in range(3):
        cin = 64 if k == 0 else 256
        bk = dict(w1=r(cin, 64), b1=r(64), w2=r(3, 3, 64, 64), b2=r(64), w3=r(64, 256), b3=r(256))
        if k == 0:
            bk.update(wd=r(cin, 256), bd=r(256))
        blocks.append(bk)
    return blocks


def _chain(fn):
    """fn applied to each layer1 block in turn."""
    def layer(x, blocks):
        for bk in blocks:
            x = fn(x, bk["w1"], bk["b1"], bk["w2"], bk["b2"], bk["w3"], bk["b3"],
                   bk.get("wd"), bk.get("bd"))
        return x
    return layer


def run(batch: int = BATCH, hw=(HEIGHT, WIDTH), stages=STAGES, device: DeviceLike = None,
        dtype: torch.dtype = torch.bfloat16, timed: bool = True) -> List[dict]:
    """Run every section; returns one record per row (section, name, ms or
    None, relmax). `timed` False (the only choice on the CPU) checks only."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)

    def r(*shape):  # a weight, as the TPU tool draws it
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.1).to(device, dtype)

    def act(*shape):  # an activation, drawn on the device
        return (torch.randn(shape, generator=gen, device=device) * 0.1).to(dtype)

    rows, ref, section = [], None, ""

    def start(title):
        nonlocal ref, section
        ref, section = None, title
        print(f"== {title} B={batch} {dtype} on {device} ==", flush=True)

    def check(name, fn, x, *args, **kw):
        nonlocal ref
        out = fn(x, *args, **kw).float()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{section} / {name}: non-finite output")
        if ref is None:
            ref = out
        relmax = ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
        ms = device_ms_chained(lambda a: fn(a, *args, **kw), x) if timed else None
        shown = f"{ms:8.3f} ms" if timed else "(not timed)"
        print(f"  {name:44s} {shown}   relmax={relmax:.2e}", flush=True)
        rows.append(dict(section=section, name=name, ms=ms, relmax=relmax))

    def v2_name(tile, im2col, cmid, downsample=False):
        name = f"v2 tile={tile} im2col={int(im2col)}"
        if device.type == "cuda":
            plan = bottleneck_plan(False, tile, cmid, im2col, dtype, downsample)
            name += (f" (tw={plan['tile_w']} band={plan['band_h']} "
                     f"chain={plan['k_chunk']})")
        return name

    H, W = hw
    start(f"layer1 inner block (cin=256) {H}x{W}")
    x = act(batch, H, W, 256)
    w = dict(w1=r(256, 64), b1=r(64), w2=r(3, 3, 64, 64), b2=r(64), w3=r(64, 256), b3=r(256))
    check("plain", bottleneck_plain, x, **w)
    check("fused v1 (shipped, tile 8)", fused_bottleneck, x, **w)
    for tile in TILES:
        for im2col in (False, True):
            check(v2_name(tile, im2col, 64), fused_bottleneck_v2, x, **w, tile_h=tile,
                  im2col=im2col)

    start("layer1 block0 (cin=64, downsample)")
    x0 = act(batch, H, W, 64)
    w0 = dict(w, w1=r(64, 64), wd=r(64, 256), bd=r(256))
    check("plain", bottleneck_plain, x0, **w0)
    check("fused v1 (shipped, tile 8)", fused_bottleneck, x0, **w0)
    check(v2_name(8, True, 64, True), fused_bottleneck_v2, x0, **w0, tile_h=8, im2col=True)

    for stage, (h, sw, cin, cmid) in stages.items():
        start(f"{stage} inner block ({h}x{sw} cin={cin} cmid={cmid})")
        xs = act(batch, h, sw, cin)
        ws = dict(w1=r(cin, cmid), b1=r(cmid), w2=r(3, 3, cmid, cmid), b2=r(cmid),
                  w3=r(cmid, cin), b3=r(cin))
        check("plain", bottleneck_plain, xs, **ws)
        check(v2_name(8, True, cmid), fused_bottleneck_v2, xs, **ws, tile_h=8, im2col=True)

    start("full layer1 (3 chained blocks)")
    blocks = blocks_from_numpy(make_layer1_blocks(rng), dtype, device)
    check("plain layer1", layer1_plain, x0, blocks)
    check("3x fused v1 (shipped, tile 8)", _chain(fused_bottleneck), x0, blocks)
    check("3x v2 tile=8 im2col=1", _chain(fused_bottleneck_v2), x0, blocks)
    for tile in V3_TILES:
        name = f"v3 chained tile={tile}"
        if device.type == "cuda":
            plan = bottleneck_plan(True, tile, 64, True, dtype)
            tw, band = plan["tile_w"], plan["band_h"]
            name += f" (tw={tw} band={band}, {layer1_recompute(band, tw):.2f}x ops)"
        check(name, fused_layer1, x0, blocks, tile_h=tile)
    print("DONE", flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="tiny shapes on the CPU through the plain versions, untimed")
    args = parser.parse_args(argv)
    if args.check:
        run(**CHECK, device="cpu", dtype=torch.float32, timed=False)
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
