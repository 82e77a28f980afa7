#!/usr/bin/env python3
"""Where a training step of aspire_tpu_torch spends its time, by kernel.

    python3 benchmarks/torch_train_profile.py [--layers 12] [--steps 3]   # one GPU

Builds the flagship training configuration of `chip_smoke.py` (ts+otAspire,
full BERT-base width, bf16 over f32 parameters, Adam, superbatch [10, 3, 512],
one wide encode a side) and prints, one JSON object a line:

  steps     host-clock milliseconds of `--steps` warm optimizer steps through
            `Trainer.train_step`, each ending in a synchronise;
  profile   the same steps under `torch.profiler`: the device's span, busy
            time and idle share, and the busy time by class of kernel (the
            port's own attention and dropout kernels, the cuBLAS products,
            everything else);
  phases    one more step taken apart under the profiler with a synchronise
            after each phase: the two wide encodes, the group losses (the plain
            Sinkhorn solver's small ops), the backward, the optimizer --
            host milliseconds, device busy milliseconds and kernels launched;
  kernel    the device kernels of the profiled steps by total time.

Last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the model, weight and batch generators)

CLASSES = (
    ("attention_dropout (K5a)", ("attention_bf16_kernel", "attention_f32_kernel")),
    ("attention_bwd (K5b)", ("bwd_delta_", "bwd_keys_", "bwd_dq_", "bwd_rows_")),
    ("dropout (K6)", ("dropout_kernel",)),
    ("cuBLAS products", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def classify(name: str) -> str:
    for label, needles in CLASSES:
        if any(n in name for n in needles):
            return label
    return "other device kernels"


def device_events(prof):
    """Kernels and copies on the device; the device-side echoes of host
    ranges (autograd functions, the optimizer step) are left out."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name and not e.name.startswith("phase:")]


def busy_ms(events) -> float:
    """Time during which at least one of the events ran (milliseconds)."""
    total, end = 0.0, None
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e3


def phased_step(model, trainer, state, sb, rng) -> None:
    """One optimizer step as Trainer.train_step takes it, with a named range
    and a synchronise around each phase."""
    from aspire_tpu_torch.models.doc_models import _flatten, draw_step_rng

    def phase(name):
        return record_function("phase:" + name)

    model.train(True)
    state.optimizer.zero_grad(set_to_none=True)
    n_micro, gb = sb["query"]["token_ids"].shape[:2]
    flat = _flatten(sb, n_micro * gb)
    with phase("encode"):
        draws = [draw_step_rng(rng, gb, True) for _ in range(n_micro)]
        reps = model._encode_triple(flat, draws[0][0], False)
        torch.cuda.synchronize()
    with phase("group_losses"):
        perm = torch.cat([g * gb + draws[g][1] for g in range(n_micro)])
        terms = model._group_loss(flat, reps, perm, groups=n_micro)
        total = terms.sum()
        torch.cuda.synchronize()
    with phase("backward"):
        total.backward()
        torch.cuda.synchronize()
    with phase("optimizer"):
        if bool(torch.isfinite(total.detach())):
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from aspire_tpu_torch.core.config import RunConfig, TrainHParams
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.train.trainer import Trainer, tree_to_device

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig(num_hidden_layers=args.layers)
    hp, model = chip_smoke.flagship(cfg, dev)
    tp = TrainHParams(batch_size=3, accumulated_batch_size=30, learning_rate=2e-5,
                      num_warmup_steps=20, train_size=3000)
    batches = [tree_to_device(chip_smoke.synth_superbatch(
        500 + i, 10, 3, 512, 20, cfg.vocab_size), dev) for i in range(args.steps)]
    rng = torch.Generator().manual_seed(1)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, RunConfig(hp, tp), tmp, fused_accum=True)
        state = trainer.init_state()
        for sb in batches[:2]:                       # warm-up, kernel build
            trainer.train_step(state, sb, rng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for sb in batches:
            t0 = time.perf_counter()
            trainer.train_step(state, sb, rng)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"steps": step_ms, "layers": args.layers,
                          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}))

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for sb in batches:
                trainer.train_step(state, sb, rng)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        if not events:
            raise RuntimeError("the profiler recorded no device activity")
        span_ms = (max(e.time_range.end for e in events)
                   - min(e.time_range.start for e in events)) / 1e3
        busy = busy_ms(events)
        by_class: dict = {}
        by_name: dict = {}
        for e in events:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            label = classify(e.name)
            by_class[label] = by_class.get(label, 0.0) + ms
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + ms, count + 1)
        print(json.dumps({
            "profile": {"steps": args.steps, "device_span_ms": span_ms,
                        "device_busy_ms": busy,
                        "device_idle_share": 1.0 - busy / span_ms,
                        "host_wall_ms_with_profiler": wall_ms,
                        "device_kernels": len(events),
                        "busy_ms_a_step_by_class": {
                            k: v / args.steps for k, v in sorted(by_class.items())},
                        "share_of_busy_by_class": {
                            k: v / busy for k, v in sorted(by_class.items())}}}))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            phased_step(model, trainer, state, batches[0], rng)
        events = device_events(prof)
        phases = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith("phase:"):
                lo, hi = e.time_range.start, e.time_range.end
                inside = [k for k in events if lo <= k.time_range.start <= hi]
                classes: dict = {}
                for k in inside:
                    label = classify(k.name)
                    classes[label] = classes.get(label, 0.0) + (
                        k.time_range.end - k.time_range.start) / 1e3
                phases[e.name[6:]] = {"host_ms": (hi - lo) / 1e3,
                                      "device_busy_ms": busy_ms(inside),
                                      "device_kernels": len(inside),
                                      "busy_ms_by_class": classes}
        print(json.dumps({"phases": phases}))

    rows = sorted(((ms, count, name) for name, (ms, count) in by_name.items()),
                  reverse=True)
    for ms, count, name in rows[:args.top]:
        print(json.dumps({"kernel": name[:100], "class": classify(name),
                          "device_ms_a_step": ms / args.steps,
                          "share_of_busy": ms / busy,
                          "calls_a_step": count / args.steps}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
