"""Serving entry point (port of runs/serve.py): multi-stream micro-batched
inference of the flagship on one CUDA card.

Loads a port checkpoint (or serves random weights from seed 0 for a smoke
run), builds the flagship and serves N asynchronous video streams through
`future_od_tpu_torch.serve.MultiStreamServer`: fixed-shape micro-batches
over a feature ring on the card (see serve/server.py).

The frames are synthetic (the run measures the serving fabric itself): a
pool of (H, W, 3) frames with per-key (d,) IMU vectors, made before the
timed loop. With --device_normalize the frames are uint8 and the backbone
normalizes them on the card (4x fewer bytes to copy). --bf16 casts the
model to bf16 (every float tensor, as the JAX script casts every f32 leaf).
It prints one JSON line: clips/s, clips, p50/p95/p99 submit-to-result
latency and the server's stats.

Run it as a module from the repo root:
  python -m future_od_tpu_torch.runs.serve --streams 24 --max_batch 12
  python -m future_od_tpu_torch.runs.serve --checkpoint nusc_spatiotemporal_imu_500ms_final --bf16
  python -m future_od_tpu_torch.runs.serve --mesh_data 2
--mesh_data N serves over N cards of this machine (`parallel/mesh.py::
make_mesh(N, 1)`): the streams spread over them, one model replica a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import deque

import numpy as np
import torch

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import IMU_WIDTHS, SpatioTemporalDETRArgs
from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.runs.config import config
from future_od_tpu_torch.serve import MultiStreamServer
from future_od_tpu_torch.utils.checkpoint import load_checkpoint


def build_parser():
    parser = argparse.ArgumentParser(description="Multi-stream serving entry")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint name under --checkpoint_dir "
                        "(e.g. a trainer <name>_final); random init if absent")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="checkpoint directory (default: the repo "
                        "config checkpoint_path)")
    parser.add_argument("--streams", default=24, type=int)
    parser.add_argument("--max_batch", default=12, type=int)
    parser.add_argument("--max_streams", default=64, type=int)
    parser.add_argument("--img_size", nargs=2, default=[896, 1600], type=int)
    parser.add_argument("--num_classes", default=8, type=int)
    parser.add_argument("--clip_frames", default=3, type=int)
    parser.add_argument("--rounds", default=8, type=int,
                        help="round-robin passes over the streams")
    parser.add_argument("--bf16", action="store_true", default=False)
    parser.add_argument("--device_normalize", action="store_true", default=False,
                        help="ship uint8 frames, normalize on device")
    parser.add_argument("--mesh_data", default=0, type=int,
                        help="serve over an N-card data mesh")
    return parser


def load_model(args):
    """The flagship, built from the checkpoint's `detr_args` when it has
    them (an architecture the CLI defaults could silently differ from:
    an encode_offset run has the same parameters), else from the CLI, with
    the checkpoint's net loaded."""
    blob = None
    if args.checkpoint:
        ckpt_dir = args.checkpoint_dir or config["checkpoint_path"]
        blob = load_checkpoint(ckpt_dir, args.checkpoint, map_location="cpu")
        if blob is None:
            raise SystemExit(f"checkpoint not found: {args.checkpoint}")
    if blob is not None and blob.get("detr_args"):
        fields = {f.name for f in dataclasses.fields(SpatioTemporalDETRArgs)}
        detr_args = SpatioTemporalDETRArgs(
            **{k: v for k, v in blob["detr_args"].items() if k in fields})
        print("model architecture from checkpoint meta")
    else:
        detr_args = SpatioTemporalDETRArgs(num_classes=args.num_classes, num_queries=128,
                                           lr_backbone=1e-4)
    model = build_flagship(detr_args)
    if blob is not None:
        if blob.get("net_type") != type(model).__name__:
            raise ValueError(f"checkpoint holds a {blob.get('net_type')}, this script serves a "
                             f"{type(model).__name__}")
        model.load_state_dict(blob["net"], strict=True)
        print(f"loaded checkpoint {args.checkpoint}")
    return model


def main(argv=None):
    """Parse `argv` (default: the command line), serve, print the JSON
    line; returns it as a dict."""
    args = build_parser().parse_args(argv)
    H, W = args.img_size
    model = load_model(args)
    if args.bf16:
        model.to(torch.bfloat16)
    mesh = None
    if args.mesh_data:
        mesh = make_mesh(num_data=args.mesh_data, num_model=1)
        print(f"serving over a {args.mesh_data}-chip data mesh")
    server = MultiStreamServer(model, max_batch=args.max_batch, clip_frames=args.clip_frames,
                               max_streams=args.max_streams, mesh=mesh,
                               device=next(model.parameters()).device)

    rng = np.random.default_rng(0)

    # A small frame pool made OUTSIDE the timed loop: drawing a (896, 1600,
    # 3) frame costs the host tens of ms, so in-loop generation would time
    # frame synthesis, not the serving fabric.
    def make_frame():
        if args.device_normalize:
            video = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
        else:
            video = rng.normal(size=(H, W, 3)).astype(np.float32)
        f = {"video": video}
        for key, d in IMU_WIDTHS.items():
            f[key] = rng.normal(size=(d,)).astype(np.float32)
        return f

    pool = [make_frame() for _ in range(min(args.streams, 8))]

    def frame_source(stream_id, t):
        return pool[(stream_id + t) % len(pool)]

    submit_t = {s: deque() for s in range(args.streams)}
    latencies, clips = [], 0

    def consume(results):
        nonlocal clips
        for placements, out in results:
            out["boxes"].cpu()  # one sync per dispatch
            done = time.perf_counter()
            for sid, _row in placements:
                # clips complete in submit order within a stream: the OLDEST
                # pending submit, so a queued frame is timed from its own
                latencies.append(done - submit_t[sid].popleft())
            clips += len(placements)

    # warm up (fill the windows), then serve
    for t in range(args.clip_frames - 1):
        for s in range(args.streams):
            server.submit(s, frame_source(s, t))
    server.flush()
    t0 = time.perf_counter()
    for t in range(args.rounds):
        for s in range(args.streams):
            submit_t[s].append(time.perf_counter())
            consume(server.submit(s, frame_source(s, t)))
    consume(server.flush())
    elapsed = time.perf_counter() - t0

    lat = np.asarray(latencies) * 1e3
    line = {
        "clips_per_sec": round(clips / elapsed, 2),
        "clips": clips,
        "latency_ms_p50": round(float(np.percentile(lat, 50)), 1),
        "latency_ms_p95": round(float(np.percentile(lat, 95)), 1),
        "latency_ms_p99": round(float(np.percentile(lat, 99)), 1),
        **{k: round(v, 4) for k, v in server.stats().items()},
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
