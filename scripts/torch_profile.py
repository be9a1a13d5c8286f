"""Where the time of one utterance goes in the PyTorch/CUDA port.

    python3 scripts/torch_profile.py [--tokens 24] [--dtype bfloat16] [--seed 1234] [--stream]

Needs one CUDA card. Builds ``real_arch()`` synthetic weights from the seed,
warms up, then:

1. runs the three stages of ``GPURuntime.generate_audio`` (prefill, AR loop,
   decode) with a device sync after each and prints their wall times (the
   AR loop's the median of three runs: the host sets it, and it varies),
   then the AR loop once more under ``torch.profiler`` for its device ops
   per step;
2. runs one whole request under ``torch.profiler`` and prints the device
   busy time (sum of kernel times) against the request's wall time, and the
   kernels that take the most device time.

With ``--stream`` it does the same for ``stream_generate``: the stages up
to the first block (setup and prefill, the first segment's AR steps, its
block decode, the copy to the host), each synced, then one streamed
request under the profiler.

EOS is disabled (threshold 1e9), so the frame count is the chunk's budget.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from go_pocket_tts_tpu_torch.models import synthetic  # noqa: E402
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors  # noqa: E402
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime  # noqa: E402
from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames  # noqa: E402
from go_pocket_tts_tpu_torch.utils import buckets as bk  # noqa: E402


def _sync_time(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, memsets) that ``fn`` runs, from
    ``torch.profiler``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)


def _first_block_stages(rt, tokens, cfg) -> str:
    """The path to the first streamed block, stage by stage, as
    ``runtime.streaming`` runs it."""
    from go_pocket_tts_tpu_torch.models import mimi_stream
    from go_pocket_tts_tpu_torch.runtime import streaming
    from go_pocket_tts_tpu_torch.runtime.generate import HostCopy

    segment = streaming.SEGMENT_FRAMES
    model, mimi_cfg = rt.model, rt.model.config.mimi
    with torch.inference_mode():
        (cache, max_steps, decode_steps, frame_bucket, _), setup_ms = _sync_time(lambda: rt._setup(tokens, cfg))
        state = mimi_stream.init_stream_state(
            model.params["mimi"],
            mimi_cfg,
            1,
            (frame_bucket + streaming.MAX_SEGMENT_FRAMES) * mimi_cfg.steps_per_latent,
            rt.dtype,
        )
        (frames, n, _), ar_ms = _sync_time(lambda: rt._ar_loop(cache, cfg, segment, decode_steps, segment))

        def decode():
            latent = model.latent_to_mimi(frames)
            return mimi_stream.decode_block(model.params["mimi"], mimi_cfg, state, latent)[0]

        pcm, decode_ms = _sync_time(decode)
        _, copy_ms = _sync_time(lambda: HostCopy(pcm.float()).numpy())
    total = setup_ms + ar_ms + decode_ms + copy_ms
    return (
        f"first block (wall, synced): setup + prefill {setup_ms:.2f} ms  {segment} AR steps {ar_ms:.2f} ms "
        f"({ar_ms / segment:.3f} ms/step)  block decode {decode_ms:.2f} ms  copy {copy_ms:.2f} ms  "
        f"sum {total:.2f} ms"
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--stream", action="store_true", help="profile stream_generate instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    dtype = getattr(torch, args.dtype)
    arch = synthetic.real_arch()
    model = load_model_from_tensors(
        synthetic.build_checkpoint(arch, seed=args.seed), num_heads=arch.num_heads, dtype=dtype
    )
    rt = GPURuntime(model, dtype=dtype, seed=args.seed)
    tokens = np.random.RandomState(args.seed).randint(0, arch.n_bins, size=args.tokens).tolist()
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9)
    rt.generate_audio(tokens, cfg)  # warm-up
    if args.stream:
        from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate

        for _ in stream_generate(rt, tokens, cfg):  # warm-up
            pass

    if args.stream:
        print(f"card: {card}; torch {torch.__version__}; {args.dtype}; tokens {len(tokens)}; streamed")
        print(_first_block_stages(rt, tokens, cfg))
    else:
        _print_stages(rt, tokens, cfg, card, args.dtype)

    def request():
        if args.stream:
            return [len(b) for b in stream_generate(rt, tokens, cfg)]
        return rt.generate_audio(tokens, cfg)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, wall_ms = _sync_time(request)
    events = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    print(
        f"profiled {'streamed ' if args.stream else ''}request: wall {wall_ms:.2f} ms, device busy "
        f"{kernel_us / 1e3:.2f} ms ({100 * kernel_us / 1e3 / wall_ms:.1f}% busy, "
        f"{100 - 100 * kernel_us / 1e3 / wall_ms:.1f}% idle)"
    )
    print("top device time:")
    rows = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total,
        reverse=True,
    )
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:100]}")
    return 0


def _print_stages(rt, tokens, cfg, card: str, dtype: str) -> None:
    """The one-shot request's three stages, each synced."""
    max_steps = estimate_max_frames(len(tokens))
    frame_bucket = bk.pick_bucket(max_steps + 1, (rt.frame_bucket, 512, 1024))
    token_bucket = bk.pick_bucket(len(tokens), bk.PROMPT_BUCKETS)
    capacity = bk.round_up(token_bucket, 64) + frame_bucket
    padded = torch.zeros((1, token_bucket), dtype=torch.int64, device=rt.device)
    padded[0, : len(tokens)] = torch.tensor(tokens)
    with torch.inference_mode():
        cache, prefill_ms = _sync_time(lambda: rt._prefill(padded, len(tokens), capacity))
        ar_runs = []
        for run in range(3):
            if run:
                cache = rt._prefill(padded, len(tokens), capacity)
            # (frames, n_frames) lead what the loop returns.
            (frames, n_frames), ms = _sync_time(lambda: rt._ar_loop(cache, cfg, max_steps, 1, frame_bucket)[:2])
            ar_runs.append(ms)
        _, decode_ms = _sync_time(
            lambda: rt._decode_pcm16(frames, n_frames, min(bk.round_up(max_steps, 32), frame_bucket))
        )
        cache = rt._prefill(padded, len(tokens), capacity)
        ar_ops = _device_ops(lambda: rt._ar_loop(cache, cfg, max_steps, 1, frame_bucket))
    n = int(n_frames[0])
    ar_ms = statistics.median(ar_runs)
    print(f"card: {card}; torch {torch.__version__}; {dtype}; tokens {len(tokens)}; frames {n}")
    print(
        f"stages (wall, synced): prefill {prefill_ms:.2f} ms  AR loop {ar_ms:.2f} ms "
        f"({ar_ms / n:.3f} ms/step; runs {', '.join(f'{t:.2f}' for t in ar_runs)} ms)  decode {decode_ms:.2f} ms"
    )
    print(f"AR loop under the profiler: {ar_ops} device ops ({ar_ops / n:.1f} per step)")


if __name__ == "__main__":
    sys.exit(main())
