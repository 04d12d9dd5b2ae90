#!/usr/bin/env python
"""The `fast` and `oracle` render paths as CUDA graphs on the card: what a
graph of each costs and saves, and whether a K-frame batch graph pays.

For each path, an Engine at --size (island, day 6, FXAA on, the config's
chunk) renders frame() eagerly, captures its graph at the second call and
replays it after. Printed per path:

  eager_ms         _frame_eager(): the early exits of `fast` decided on the
                   host, by CUDA events, one call per turn;
  masked_eager_ms  the same frame with every bounce and sweep run, masked,
                   launched eagerly (what the graph holds), by CUDA events;
  replay_ms        the frame() graph by replay, CUDA events around 3
                   replays, in turns with eager_ms;
  host_ms          host milliseconds per frame() call, 3 calls enqueued
                   from an idle device; host_ms_after_profiler the same
                   once a torch.profiler trace of one frame() call has run
                   in the process;
  capture_s        the capture and instantiation (Engine._capture);
  nodes            the graph's node count (cudaGraphGetNodes);
  pool_mb          (allocated, reserved) MB the graph's pool kept;
  equal            the replay equals _frame_eager() bit for bit.

With --batch K (path `fast` only, the first path given): the K-frame graph
of Engine._step_render("batch", ...) (K step + render frames in one
graph, the form a batch took before it became K step_and_frame replays):
its capture seconds, nodes, pool and replay ms, beside K replays of the
step_and_frame graph by CUDA events; and the batch graph's frames against
K step_and_frame replays, bit for bit.

  python experiments/plain_graphs_torch.py [--size 1280x720]
      [--paths fast,oracle] [--batch 8] [--out report.json]

Card only: exits 2 where torch.cuda.is_available() is false.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from chip_smoke import card_line, from_idle, make_state, timed
from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.render.pipeline import pack_actions
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils import profiling
from raytracing_cuda_tpu_torch.utils.timing import graph_nodes, replay_ms


def mb(memory) -> list:
    return [round(b / 2 ** 20, 1) for b in memory]


def frame_graph(eng: Engine) -> dict:
    """frame()'s graph against the eager frame, in turns."""
    st = eng.state
    for _ in range(2):                     # eager, then the capture
        eng.frame()
    g = eng._graphs[("render", 1)]
    equal = torch.equal(eng.frame(), eng._frame_eager())
    eager, replay = [], []
    for turn in ("eager", "replay", "replay", "eager"):
        if turn == "eager":
            eager.append(timed(eng._frame_eager)[1])
        else:
            replay.append(replay_ms(g.graph, 1, 3))
    masked = timed(lambda: eng._step_render("render", st, None,
                                            early_exit=False))[1]
    host_ms = from_idle(eng.frame, 3)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            eng.frame()
            torch.cuda.synchronize()
    return {"equal": equal, "eager_ms": eager, "masked_eager_ms": masked,
            "replay_ms": replay, "host_ms": host_ms,
            "host_ms_after_profiler": from_idle(eng.frame, 3),
            "capture_s": g.seconds, "pool_mb": mb(g.memory),
            "nodes": graph_nodes(lambda: eng._step_render(
                "render", st, None, early_exit=False))}


def batch_graph(eng: Engine, k: int) -> dict:
    """The K-frame graph beside K replays of the step_and_frame graph."""
    vecs = pack_actions([Action.idle()] * k, [1 / 60] * k)
    st = eng.state
    for _ in range(2):                     # warm step_and_frame's graph
        eng.step_and_frame()
    g1 = eng._graphs[("frame", 1)]
    eng.set_state(st)
    eng._run_single("batch", vecs)         # eager
    eng.set_state(st)
    t0 = time.perf_counter()
    got = eng._run_single("batch", vecs)   # capture + replay
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    gk = eng._graphs[("batch", k)]
    eng.set_state(st)
    want = eng.step_and_frame_batch(vecs)  # K step_and_frame replays
    k_replays = []
    for _ in range(2):
        k_replays.append(replay_ms(g1.graph, 1, k) * k)
    devs = eng._upload(vecs)
    return {"k": k, "equal_to_k_replays": torch.equal(got, want),
            "capture_s": gk.seconds, "first_call_s": first_call_s,
            "pool_mb": mb(gk.memory), "replay_ms": replay_ms(gk.graph, 1, 1),
            "frame_graph_k_replays_ms": k_replays,
            "frame_graph_capture_s": g1.seconds,
            "frame_graph_pool_mb": mb(g1.memory),
            "nodes": graph_nodes(lambda: eng._step_render(
                "batch", st, devs, early_exit=False))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--paths", default="fast,oracle")
    ap.add_argument("--batch", type=int, default=8,
                    help="K of the batch graph measured on the first path "
                         "(0: none)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plain_graphs_torch: needs a CUDA card", file=sys.stderr)
        return 2
    w, h = (int(v) for v in args.size.split("x"))
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} [{card}]", flush=True)
    cfg = RenderConfig(width=w, height=h)
    report = {"card": card, "size": args.size, "chunk": cfg.chunk}
    for i, path in enumerate(args.paths.split(",")):
        eng = Engine(dataclasses.replace(cfg, path=path), "cuda")
        eng.set_state(make_state(6.0))
        res = frame_graph(eng)
        print(f"{path} {args.size}: {json.dumps(res)} [{card}]", flush=True)
        if i == 0 and args.batch:
            res["batch"] = batch_graph(eng, args.batch)
            print(f"{path} batch: {json.dumps(res['batch'])} [{card}]",
                  flush=True)
        report[path] = res
        del eng
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    ok = all(report[p]["equal"] for p in args.paths.split(","))
    ok &= all(r["batch"]["equal_to_k_replays"] for r in report.values()
              if isinstance(r, dict) and "batch" in r)
    print(json.dumps({"ok": ok, "median_replay_ms": {
        p: statistics.median(report[p]["replay_ms"])
        for p in args.paths.split(",")}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
