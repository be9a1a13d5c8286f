"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a host with a CUDA card and ``nvcc``. It
imports nothing of JAX nor of the JAX package. Phases, in order; any
failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``go_pocket_tts_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in float32 and bfloat16, and time both (CUDA events,
   device time from CUDA-graph replay) beside a library call where one
   exists;
3. the main path: ``real_arch()`` weights from a fixed seed, bfloat16 on the
   card, ``GPURuntime.generate_audio`` on three requests (a warm-up request
   first), then one ``PocketTTSModel.mimi_decode`` of a latent whose length
   takes the decoder's fallback tail; every launch count is set to 0 just
   before and read just after, and each must be positive;
4. float32: the runtime with the kernels against the same runtime with every
   kernel replaced by its plain version, held to an RMS tolerance.

The last lines are the kernel table as one JSON object, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
CARD = ""  # nvidia-smi name and power limit, set in main()

# Peak rates of one H100 SXM (dense, NVIDIA data sheet) for the bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel vs plain version, (atol, rtol): float32 differs only by summation
# order; in bfloat16 both keep float32 intermediates and round the result
# (and the appended cache rows) once, so they differ by at most ~1 ulp.
KERNEL_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-2)}
# Whole path at float32, kernels vs plain versions (the parity budget).
PATH_RMS_TOL = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(fn, n: int) -> float:
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def eager_ms(fn, n: int = 30) -> float:
    """Median CUDA-event time of one eager call, in ms: what a caller pays
    per call now, host launch overhead included."""
    for _ in range(3):
        fn()
    return _median_event_ms(fn, n)


def device_ms(fn, per_graph: int = 20, n: int = 10) -> float:
    """Device time of one call, in ms: ``per_graph`` calls captured in one
    CUDA graph, replayed ``n`` times; median replay time over
    ``per_graph``. Replay runs the launches back to back, so host overhead
    drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _median_event_ms(graph.replay, n) / per_graph
    del graph
    return ms


def bound(bytes_moved: float, flops: float, dtype: torch.dtype):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, what: str) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    atol, rtol = KERNEL_TOL[dtype]
    err = (g - w).abs()
    excess = (err - (atol + rtol * w.abs())).max().item()
    if excess > 0:
        fail(f"{what}: max abs err {err.max().item():.3e} beyond atol {atol} + rtol {rtol}")
    return err.max().item()


def dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# -- phase 2: kernels against their plain versions -------------------------------


def check_decode_attention(rows: dict) -> None:
    from go_pocket_tts_tpu_torch.kernels import decode_attention as da
    from go_pocket_tts_tpu_torch.ops import build_rope_tables

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_layers, b, h, d, layer = 6, 1, 16, 64, 3
    cos, sin = (t.cuda() for t in build_rope_tables(8192, d))
    for dtype in (torch.float32, torch.bfloat16):
        for cap in (320, 1024):
            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

            q, k_new, v_new = rnd(b, h, 1, d), rnd(b, h, 1, d), rnd(b, h, 1, d)
            kc, vc = rnd(n_layers, b, h, cap, d, scale=0.3), rnd(n_layers, b, h, cap, d, scale=0.3)
            for off in (0, cap // 2, cap - 1):
                offset = torch.tensor(off, dtype=torch.int32, device="cuda")
                kk, vk = kc.clone(), vc.clone()
                kp, vp = kc.clone(), vc.clone()
                got, _, _ = da.decode_attention_step(q, k_new, kk, vk, v_new, offset, cos, sin, layer)
                want, _, _ = da.decode_attention_step_plain(
                    q, k_new, kp, vp, v_new, offset, cos, sin, layer
                )
                what = f"decode_attention {dname(dtype)} C={cap} offset={off}"
                err = max(
                    max_err(got, want, dtype, what),
                    max_err(kk, kp, dtype, what + " k_cache"),
                    max_err(vk, vp, dtype, what + " v_cache"),
                )
                def run():
                    return da.decode_attention_step(q, k_new, kk, vk, v_new, offset, cos, sin, layer)

                ms, call_ms = device_ms(run), eager_ms(run)
                plain_ms = device_ms(
                    lambda: da.decode_attention_step_plain(q, k_new, kp, vp, v_new, offset, cos, sin, layer)
                )
                # Yardstick: one fused library call over the same visible rows.
                kv = (kk[layer, :, :, : off + 1], vk[layer, :, :, : off + 1])
                lib_ms = device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(q, kv[0], kv[1])
                )
                es = torch.finfo(dtype).bits // 8
                bh = b * h
                bytes_moved = es * bh * d * (3 + 2 * (off + 1) + 2 + 1) + 2 * 4 * (d // 2)
                flops = 4.0 * bh * (off + 1) * d
                b_ms, b_by = bound(bytes_moved, flops, dtype)
                print(
                    f"  {what}: max_abs_err {err:.3e}  kernel {ms:.5f} ms (eager call {call_ms:.4f} ms)  "
                    f"plain {plain_ms:.5f} ms  sdpa {lib_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
                )
                if dtype == torch.bfloat16 and cap == 320 and off == cap - 1:
                    rows["decode_attention_step"].update(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms,
                    )


def _tail_inputs(gen, dtype, up: bool):
    from go_pocket_tts_tpu_torch.ops import repack_conv_transpose_kernel

    def rnd(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    head = []
    if up:
        wu = repack_conv_transpose_kernel(
            torch.randn((128, 64, 8), generator=gen, device="cuda") * 0.1
        ).to(dtype)
        head = [wu, rnd(64)]
    tail = [rnd(32, 64, 3), rnd(32), rnd(64, 32, 1), rnd(64), rnd(1, 64, 7), rnd(1)]
    return head + tail


def check_seanet(rows: dict) -> None:
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    frames = 160  # a 12.8 s decode
    t_in = 480 * frames  # 76,800 pre-up3 columns
    t_out = 1920 * frames
    for name, up, c_in, t_x, flop_per_sample, kernel, plain in (
        ("fused_seanet_up_tail", True, 128, t_in, 50048, st.fused_seanet_up_tail, st.fused_seanet_up_tail_plain),
        ("fused_seanet_tail", False, 64, t_out, 17280, st.fused_seanet_tail, st.fused_seanet_tail_plain),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((1, c_in, t_x), generator=gen, device="cuda") * 0.5).to(dtype)
            ws = _tail_inputs(gen, dtype, up)
            got = kernel(x, *ws)
            want = plain(x, *ws)
            if tuple(got.shape) != (1, 1, t_out):
                fail(f"{name}: output shape {tuple(got.shape)}")
            what = f"{name} {dname(dtype)} x={tuple(x.shape)}"
            err = max_err(got, want, dtype, what)
            ms = device_ms(lambda: kernel(x, *ws), per_graph=5)
            plain_ms = device_ms(lambda: plain(x, *ws), per_graph=5)
            es = torch.finfo(dtype).bits // 8
            bytes_moved = es * (x.numel() + sum(w.numel() for w in ws) + t_out)
            b_ms, b_by = bound(bytes_moved, float(flop_per_sample) * t_out, dtype)
            print(
                f"  {what}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
            )
            if dtype == torch.bfloat16:
                rows[name].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None,
                )


# -- phases 3 and 4: the main path ------------------------------------------


def build_model(dtype: torch.dtype):
    from go_pocket_tts_tpu_torch.models import synthetic
    from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors

    arch = synthetic.real_arch()
    tensors = synthetic.build_checkpoint(arch, seed=SEED)
    return arch, load_model_from_tensors(tensors, num_heads=arch.num_heads, device="cuda", dtype=dtype)


def check_audio(audio: np.ndarray, frames: int, what: str) -> None:
    if audio.dtype != np.float32 or audio.shape != (frames * 1920,):
        fail(f"{what}: audio {audio.dtype} {audio.shape}, want float32 ({frames * 1920},)")
    if not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
        fail(f"{what}: audio not finite or outside [-1, 1]")
    if not np.abs(audio).max() > 0:
        fail(f"{what}: silent audio")


def main_path(rows: dict) -> None:
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames

    t0 = time.perf_counter()
    arch, model = build_model(torch.bfloat16)
    rt = GPURuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda")
    print(f"  real_arch bf16 weights built and loaded in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    requests = [
        (rng.randint(0, arch.n_bins, size=n).tolist(), temp)
        for n, temp in ((12, 0.0), (24, 0.7), (45, 0.7))
    ]
    rt.generate_audio(requests[0][0], GenerateConfig(temperature=0.7, eos_threshold=1e9))  # warm-up

    kernels.reset_launches()
    for i, (tokens, temp) in enumerate(requests):
        cfg = GenerateConfig(temperature=temp, eos_threshold=1e9)
        torch.cuda.synchronize()
        t = time.perf_counter()
        audio = rt.generate_audio(tokens, cfg)
        wall = time.perf_counter() - t
        frames = estimate_max_frames(len(tokens))
        check_audio(audio, frames, f"request {i}")
        secs = len(audio) / 24000
        print(
            f"  request {i}: tokens {len(tokens)} temperature {temp} frames {frames} "
            f"samples {len(audio)} wall {wall * 1e3:.1f} ms  x{secs / wall:.2f} real time  [{CARD}]"
        )
    # A 15-frame latent: its pre-up3 length (7,200) is not a multiple of 512,
    # so the decoder takes the fallback tail (up3, then fused_seanet_tail).
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    latent = torch.randn((1, 15, arch.latent_dim), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        pcm = model.mimi_decode(model.latent_to_mimi(latent))
    torch.cuda.synchronize()
    if tuple(pcm.shape) != (1, 1, 15 * 1920) or not torch.isfinite(pcm.float()).all():
        fail(f"fallback decode: pcm {tuple(pcm.shape)} or not finite")
    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    print(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
        rows[name]["launches"] = n
    del rt, model
    torch.cuda.empty_cache()


def plain_versions():
    """Swap every kernel wrapper for its plain version (module attributes the
    model code reads at call time); returns the undo function."""
    from go_pocket_tts_tpu_torch.kernels import decode_attention as da
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    saved = [
        (da, "decode_attention_step", da.decode_attention_step_plain),
        (st, "fused_seanet_up_tail", st.fused_seanet_up_tail_plain),
        (st, "fused_seanet_tail", st.fused_seanet_tail_plain),
    ]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in saved]
    for mod, attr, plain in saved:
        setattr(mod, attr, plain)

    def undo():
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)

    return undo


def f32_parity() -> None:
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

    arch, model = build_model(torch.float32)
    tokens = np.random.RandomState(SEED + 2).randint(0, arch.n_bins, size=20).tolist()
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=40)
    a = GPURuntime(model, dtype=torch.float32, seed=SEED).generate_audio(tokens, cfg)
    undo = plain_versions()
    try:
        b = GPURuntime(model, dtype=torch.float32, seed=SEED).generate_audio(tokens, cfg)
    finally:
        undo()
    check_audio(a, 40, "f32 kernels")
    check_audio(b, 40, "f32 plain")
    rms = float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))
    print(f"  f32 real_arch, 40 frames: RMS(kernels - plain) {rms:.3e} (tolerance {PATH_RMS_TOL})")
    if not rms < PATH_RMS_TOL:
        fail(f"f32 path RMS {rms} beyond {PATH_RMS_TOL}")


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("phase 1: card and build")
    CARD = card_line()
    print(CARD)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    took = build.build_all()
    print(f"  built {sorted(took)} in {time.perf_counter() - t:.1f} s (per source: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(took.items())) + ")")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    rows = {
        fn.__name__: {"name": fn.__name__, "route": "cuda", **meta, "launches": 0}
        for fn, meta in zip(kernels.WRAPPERS, kernels.META)
    }

    print("phase 2: kernels against their plain versions")
    check_decode_attention(rows)
    check_seanet(rows)

    print("phase 3: main path (real_arch, bfloat16)")
    main_path(rows)

    print("phase 4: float32 path, kernels against plain versions")
    f32_parity()

    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"kernels": list(rows.values())}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
