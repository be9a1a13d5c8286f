"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a host with a CUDA card and ``nvcc``. It
imports nothing of JAX nor of the JAX package. Phases, in order; any
failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``go_pocket_tts_tpu_torch/csrc`` and print the build time;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and time both (CUDA events, device time from
   CUDA-graph replay) beside its bound and a library call where one exists:
   decode attention (also at every split boundary of its split-KV plan) and
   the SEANet tails (float32 and bfloat16), batched decode attention at 8
   lanes x 16 heads x 384 slots with random lane offsets and at the split
   boundaries (float and int8 caches), beside the fused step the batcher
   runs (RoPE, int8 row quantization, row write and attention, its written
   rows and scales bit-equal to its plain version's), and the int8 and
   int4 matmuls at the real model's linear shapes with 1, 8 and 64 rows
   (both also in their fused form, with the bias added in x's dtype, and
   bit-equal over two calls; each beside PyTorch's int8 / int4
   weight-only matmul where this torch has a CUDA kernel for it and a
   matmul on the dequantized weight, the int4 one beside the int8 one);
3. the single-utterance path: ``real_arch()`` weights from a fixed seed,
   bfloat16 on the card, ``GPURuntime.generate_audio`` on three requests (a
   warm-up request first), then one ``PocketTTSModel.mimi_decode`` of a
   latent whose length takes the decoder's fallback tail;
4. float32: that runtime with the kernels against the same runtime with
   every kernel replaced by its plain version, held to an RMS tolerance;
5. batched serving: ``ContinuousBatcher`` at 8 slots with int8 weights and
   an int8 KV cache (the batcher's serving configuration), 16 requests of
   12-45 tokens submitted at once after a warm-up request, then 4 requests
   with a bfloat16 KV cache; prints the aggregate x real time;
6. float32 batcher: against ``GPURuntime`` for the same request, and with
   the kernels against their plain versions (int8 weights and KV cache);
7. int4 serving from an artifact: the seeded float checkpoint exported with
   int4 weights (``build_quantized_checkpoint(bits=4)``), written, loaded
   back (leaf-equal to load-time ``quantize_model_params(bits=4)``), served
   by the 8-slot int8-KV batcher (the same 16 requests as phase 5, after a
   warm-up request; 38 int4-matmul launches per batched AR step) and by
   ``GPURuntime`` on one request;
8. float32 int4 + int8-KV batcher, the kernels against their plain
   versions;
9. frame streaming (``real_arch()``, bfloat16): ``stream_generate`` on the
   12-, 24- and 45-token requests of phase 3 after a warm-up, printing each
   request's time to first audio and x real time; ``stream_generate_session``
   over three chunks; then ``generate_audio`` with a synthetic voice
   embedding and with a synthetic voice model state;
10. float32 streaming: the streamed PCM against ``generate_audio`` for the
   same seed, and the streamed path's kernels against their plain versions;
   then, on the same request, the one-shot path's kernels against its plain
   versions, the two plain paths against each other, and the streamed PCM
   truncated to int16 (as ``generate_audio`` truncates it), kernels
   against plain versions;
11. the entry points (after the path re-timing below, so that its launches
   stay out of the kernel table's totals): the seeded checkpoint written
   as safetensors and a synthetic SentencePiece tokenizer under the
   git-ignored ``build/phase11/``; ``Service.from_config`` (bfloat16,
   ``batch_slots=1``) synthesizes a three-chunk text through the pipelined
   ``generate_audio_async`` route, held at temperature 0 against
   ``GPURuntime.generate_audio`` on the same chunks' token ids; the port's
   HTTP server over that service streams three texts (``POST
   /tts/stream``, frame streaming), printing the time to the first PCM
   byte and x real time, and answers ``GET /health`` and ``/stats``; the
   server over the batcher service at ``apply_serving_autotune``'s
   settings (8 slots, int8 weights and KV cache, burst blocks) answers 8
   ``POST /tts`` sent at once, each WAV checked (24 kHz mono, frames x
   1920 samples), printing the aggregate x real time; the phase's
   launches must include kernels 1, 2, 4 (int8), 5, 7 and 8; last, ``python
   -m go_pocket_tts_tpu_torch synth`` runs as a subprocess on the card and
   must write a valid WAV;
12. batched serving, whole (after phase 11; its launches are read into a
   dict of their own and its SEANet shapes re-timed apart, so the kernel
   table's totals stay those of phases 3, 5, 7 and 9): ``BatcherRuntime``
   at the serving settings (8 slots, int8 weights and KV cache, 8-step
   blocks and 64-step bursts, prompt capacity 128), after its ``prewarm``:
   phase 5's 16 requests at once, the first 8 through ``submit_stream``
   (each lane's time to its first block, the aggregate x real time, and
   the block sizes the engine ran: 8 exactly while a lane streams, 64
   otherwise; each stream exactly its frames x 1920 samples); one burst
   with a voice embedding, a voice model state and two plain requests (the
   voiced PCM must differ from the plain); a three-chunk ``generate_session``
   and ``stream_session`` next to plain load (carried, offsets growing); a
   stream closed after its first block (its lane free within two blocks,
   the next request served); over the batcher server of phase 11 with a
   voice manifest, 8 ``POST /tts/stream`` at once (time to the first PCM
   byte, more than one PCM block per text chunk) and a voiced ``POST
   /tts``; in float32 at temperature 0, the streamed lanes against the
   same batcher's one-shot PCM (both int16), the streamed wave's kernels
   against their plain versions, and a batched session's second chunk
   against ``GPURuntime.generate_audio_session``'s, each within
   ``PATH_RMS_TOL``. Its launches must include kernels 8, 4 (int8), 5, 7
   and 2.
13. voice cloning (after phase 12's path re-timing; its launches in a dict
   of their own): a seeded 10 s speaker clip written as 16-bit 24 kHz WAV
   under the git-ignored ``build/phase13/``; the float32 ``real_arch()``
   Mimi encoder and speaker projection on the card against the same
   function on the CPU (TF32 switched on in this process: the encoder
   scopes float32 itself), held at ``ENCODE_RTOL`` relative RMS, and
   padded (blocked local attention) against unpadded (dense); the encode's
   device time at each upload bucket (64, 128, 256, 512 frames) beside its
   bound (its operations from the shapes, float32 CUDA cores), and its
   peak memory; both voice kinds exported from the clip, their kinds
   checked, then 24 tokens synthesized with each through ``GPURuntime``
   (bfloat16, temperature 0; kernels 1, 7, 2), each differing from the
   plain request; the port's server over the 8-slot int8 batcher with a
   ``VoiceUploader``: ``POST /voices`` (the first builds the encoder; then
   with and without prewarm), ``GET /voices``, a voiced ``POST /tts`` and
   ``POST /tts/stream`` (kernels 4, 5, 7, 2, 8), 409 for a duplicate id,
   400 for a 45 s clip, and a wave of 8 ``POST /tts`` with and without an
   upload beside it; last, ``python -m go_pocket_tts_tpu_torch
   export-voice`` in both formats as two subprocesses at once (default
   TF32 flags), held against the in-process exports.
14. the CLI's tools (after phase 13; its launches in a dict of their own),
   on phase 11's fixtures: ``python -m go_pocket_tts_tpu_torch doctor`` as
   a subprocess (exit 0, every line ✓, the card's name and power limit and
   the ``sm_90a`` libraries named); ``model export`` through the CLI in
   process, ``--strip-voice-cloning``, ``--quantize int8`` and
   ``--quantize int4``, each file's sha256 equal to the in-process
   exporter's, then ``model verify`` (smoke load on the card) and ``model
   dump-header`` of each; ``model download-bundle`` of a ``file://`` tar.gz
   holding the int4 artifact, the tokenizer and a ``bundle-manifest.json``,
   with ``--sha256`` (the extracted files equal the originals, ``model
   verify`` on them), and a copy with one byte flipped refused; ``bench
   --runs 3 --json`` over the single runtime (bf16; kernels 1, 7, 2) and over
   the 8-slot int8 batcher at the serving autotune (kernels 4, 5, 7, 2),
   each run's audio exactly its frames x 0.08 s, its time to first audio
   within its synthesis time, the cold run flagged; ``stageprof
   --trace-dir`` (the stage table; the Chrome trace names kernel 1's and
   kernel 2's CUDA symbols); ``generate_audio_staged`` against
   ``generate_audio`` in float32 at temperature 0 within one PCM16 step;
   last, ``python -m go_pocket_tts_tpu_torch.bench.microbench`` as a
   subprocess (the card line and six ops).
15. the last entry points (after phase 14; its launches in a dict of their
   own), on phase 11's fixtures: (a) ``PocketTTSKernel`` from the files'
   bytes, float32 at temperature 0, its one-shot WAV within one PCM16 step
   RMS of ``Service.synthesize`` (``GPURuntime``) on the same text and its
   ``progress`` route within ``PATH_RMS_TOL``; in bfloat16 the x real time
   of both routes and the progress calls; (b) ``continuity=True`` over three
   chunks with and without ``progress``, and voice bytes of both kinds
   (kernels 1, 7, 2 and 8 must launch on these routes); (c) ``--backend
   torch`` (the independent torch oracle) on the card against ``--backend
   gpu`` within ``PATH_RMS_TOL`` and against itself on the CPU within 1e-5;
   (d) ``run_parity_case`` over both, and a ``save``/``load`` round trip;
   (e) a fixture from ``scripts/torch_dump_parity.py`` on the CPU replayed
   by ``verify_fixture`` on the card's float32 model, every report ok; (f)
   the ``cli`` backend through a stub ``pocket-tts`` binary under the
   git-ignored ``build/phase15/``: ``serve --backend cli`` as a subprocess
   answers ``POST /tts`` with the stub's WAV, ``doctor --backend cli``
   prints ✓ for the binary probe, ``synth --tts-arg k=v`` passes ``--k=v``
   and is refused without ``--backend cli``; (g) ``flow_main`` on the card
   against the cached path (prefill, then kernel 1 per frame) within 1e-4,
   and ``sample_noise``'s standard deviation.

Phase 2 also holds the SEANet kernels (bf16 on tensor cores) against
their plain versions at 160 frames, bit-equal over two calls: kernels 2
and 7 also at the batcher's harvest shape, 8 lanes x 256 frames, beside
the op chains they replace; kernel 3 beside its op chain and at a ragged
length; kernel 8 whole, in 16-frame blocks with a carried halo and at 8
lanes of mixed starts, its streamed block timed at 4, 8 and 16 frames and
each size beside kernels 7 then 2 on the same input. Around each
path of phases 3, 5, 7 and 9 every launch count is set to 0 just before and
read just after; each kernel that path runs must be positive. The SEANet
wrappers also count launches by input shape; after phase 10 each SEANet
kernel is re-timed at every shape those paths launched it on, and its
device time on the paths (count x time, summed) is printed beside its
bound at those shapes.
The last lines are the kernel table as one JSON object, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
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


# Times of the first designs of kernels 1 and 4 (one block per pair), 5 and
# 6, from this phase on an NVIDIA H100 80GB HBM3 at 700.00 W, printed beside
# this run's for reference.
FIRST_DESIGN_MS = {
    "decode_attention_step": 0.01636,
    "batched_decode_attention": 0.01310,
    "batched_decode_attention_int8": 0.01266,
    "quantized_matmul": 0.00618,  # K split over blocks, float atomics into a zeroed output
    "int4_matmul": 0.00635,  # a block per (128 columns, group), float atomics into a zeroed output
}


def check_decode_attention(rows: dict) -> None:
    from go_pocket_tts_tpu_torch.kernels import decode_attention as da
    from go_pocket_tts_tpu_torch.kernels.split_kv import boundary_offsets
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
            timed = (0, cap // 2, cap - 1)
            edges = boundary_offsets(cap, b * h)
            for off in sorted(set(timed) | set(edges)):
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
                if off not in timed:
                    continue

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
                first = ""
                if dtype == torch.bfloat16 and cap == 320 and off == cap - 1:
                    first = f" (first design {FIRST_DESIGN_MS['decode_attention_step']:.5f} ms)"
                print(
                    f"  {what}: max_abs_err {err:.3e}  kernel {ms:.5f} ms{first} (eager call {call_ms:.4f} ms)  "
                    f"plain {plain_ms:.5f} ms  sdpa {lib_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
                )
                if dtype == torch.bfloat16 and cap == 320 and off == cap - 1:
                    rows["decode_attention_step"].update(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms,
                    )
            print(f"  decode_attention {dname(dtype)} C={cap}: kernel = plain at offsets {edges}")


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


# The SEANet kernels' work per call, from x's shape [B, C, T]: (float
# operations per output column, output columns per input column, output
# channels). Per column: kernel 2 50,048 (up3 32,768, res3 16,384, final
# 896), kernel 3 17,280, kernel 7 196,608 (up2 131,072 over 128 channels,
# res2 65,536), kernel 8 99,200 a PCM sample.
SEANET_WORK = {
    "fused_seanet_up_tail": (50048.0, 4, 1),
    "fused_seanet_tail": (17280.0, 1, 1),
    "fused_up2_res": (196608.0, 5, 128),
    "fused_up2_up3_tail": (99200.0, 20, 1),
}
# bf16 times of the float32 SIMT designs at 160 frames, from this phase on
# an NVIDIA H100 80GB HBM3 at 700.00 W (kernels 2 and 7 before their
# tensor-core redesign, kernels 8 and 3 before theirs), printed beside this
# run's; and kernel 8's SIMT streamed blocks of 4, 8 and 16 frames.
SEANET_DESIGN = {
    "fused_seanet_up_tail": 0.9545,
    "fused_up2_res": 0.7552,
    "fused_up2_up3_tail": 1.9328,
    "fused_seanet_tail": 0.5020,
}
CASCADE_BLOCK_DESIGN = {4: 0.1510, 8: 0.1513, 16: 0.2207}
# Every (SEANet kernel, input shape) launched on the paths of phases 3, 5, 7
# and 9, with its count (the wrappers' `.shapes`, read by read_launches).
PATH_SHAPES: dict = {}


def seanet_bound(name: str, shape, weights, dtype: torch.dtype):
    """(ms, "bytes" | "operations"): x, the weights and the output moved
    once, against the kernel's operations, at x's shape."""
    b, c, t = shape
    flop, per_col, c_out = SEANET_WORK[name]
    cols = b * per_col * t
    es = torch.finfo(dtype).bits // 8
    return bound(es * (b * c * t + sum(w.numel() for w in weights) + cols * c_out), flop * cols, dtype)


def _seanet_x(gen, shape, dtype):
    return (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(dtype)


def _up_tail_op_chain(x, wu, bu, w1, b1, w2, b2, wf, bf):
    """What ``mimi_decode`` runs without kernel 2: convT, res3, ELU and the
    final conv as separate ops in the activation dtype."""
    from go_pocket_tts_tpu_torch.ops import causal_conv1d, conv_transpose1d_trim, elu

    y = conv_transpose1d_trim(x, wu, bu, 4)
    h = causal_conv1d(elu(causal_conv1d(elu(y), w1, b1)), w2, b2)
    return causal_conv1d(elu(y + h), wf, bf)


def _tail_op_chain(x, w1, b1, w2, b2, wf, bf):
    """What ``mimi_decode`` runs without kernel 3: res3, ELU and the final
    conv as separate ops in the activation dtype."""
    from go_pocket_tts_tpu_torch.ops import causal_conv1d, elu

    h = causal_conv1d(elu(causal_conv1d(elu(x), w1, b1)), w2, b2)
    return causal_conv1d(elu(x + h), wf, bf)


def _check_one(name, kernel, plain, x, ws, dtype, out_shape):
    """Kernel vs plain version on one input: shape, tolerance, and bit-equal
    over two calls; returns the max abs error."""
    got, again = kernel(x, *ws), kernel(x, *ws)
    if tuple(got.shape) != out_shape:
        fail(f"{name}: output shape {tuple(got.shape)}")
    what = f"{name} {dname(dtype)} x={tuple(x.shape)}"
    err = max_err(got, plain(x, *ws), dtype, what)
    if not torch.equal(got, again):
        fail(f"{what}: two calls differ")
    return err


def check_seanet(rows: dict) -> None:
    """Kernels 2 and 3 at 160 frames (both on tensor cores in bf16) beside
    their op chains, kernel 2 also at the batcher's harvest shape, 8 lanes
    x 256 frames, and kernel 3 at 3 lanes of a length that ends inside its
    last block."""
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for name, up, c_in, per_frame, kernel, plain in (
        ("fused_seanet_up_tail", True, 128, 480, st.fused_seanet_up_tail, st.fused_seanet_up_tail_plain),
        ("fused_seanet_tail", False, 64, 1920, st.fused_seanet_tail, st.fused_seanet_tail_plain),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            ws = _tail_inputs(gen, dtype, up)
            shapes = [(1, c_in, per_frame * 160)]
            if up and dtype == torch.bfloat16:
                shapes.append((8, c_in, per_frame * 256))  # the harvest of 8 lanes at a 256-frame bucket
            if not up:
                x = _seanet_x(gen, (3, c_in, 128 * 241), dtype)  # 152-sample blocks: the last one ragged
                err = _check_one(name, kernel, plain, x, ws, dtype, (3, 1, 128 * 241))
                print(f"  {name} {dname(dtype)} x={tuple(x.shape)}: max_abs_err {err:.3e}, bit-equal over two calls  [{CARD}]")
            chain_fn = _up_tail_op_chain if up else _tail_op_chain
            for shape in shapes:
                x = _seanet_x(gen, shape, dtype)
                what = f"{name} {dname(dtype)} x={shape}"
                per_graph = 5 if shape[0] == 1 else 2
                err = _check_one(name, kernel, plain, x, ws, dtype, (shape[0], 1, 1920 * shape[2] // per_frame))
                ms = device_ms(lambda: kernel(x, *ws), per_graph=per_graph)
                plain_ms = device_ms(lambda: plain(x, *ws), per_graph=per_graph)
                chain_ms = device_ms(lambda: chain_fn(x, *ws), per_graph=per_graph)
                b_ms, b_by = seanet_bound(name, shape, ws, dtype)
                chain = f"  op chain {chain_ms:.4f} ms (kernel below it: {'yes' if ms < chain_ms else 'no'})"
                design = ""
                if dtype == torch.bfloat16 and name in SEANET_DESIGN and shape[0] == 1:
                    design = f" (SIMT design {SEANET_DESIGN[name]:.4f} ms)"
                print(
                    f"  {what}: max_abs_err {err:.3e}, bit-equal over two calls  kernel {ms:.4f} ms{design}  "
                    f"plain {plain_ms:.4f} ms{chain}  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
                )
                if dtype != torch.bfloat16:
                    continue
                if shape[0] == 1:
                    rows[name].update(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        op_chain_ms=chain_ms,
                    )
                else:
                    rows[name].update(harvest_ms=ms, harvest_bound_ms=b_ms, harvest_op_chain_ms=chain_ms)
                    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)


def _up2_inputs(gen, dtype):
    """Weights of up2 + res2 and of up3 + res3 + final conv at real widths."""
    from go_pocket_tts_tpu_torch.ops import repack_conv_transpose_kernel

    def rnd(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    wu2 = repack_conv_transpose_kernel(torch.randn((256, 128, 10), generator=gen, device="cuda") * 0.05).to(dtype)
    up2 = [wu2, rnd(128), rnd(64, 128, 3), rnd(64), rnd(128, 64, 1), rnd(128)]
    return up2, _tail_inputs(gen, dtype, up=True)


def _up2_op_chain(x, wu, bu, w1, b1, w2, b2):
    """What ``mimi_decode`` runs without kernel 7: convT, res2, ELU as
    separate ops in the activation dtype."""
    from go_pocket_tts_tpu_torch.ops import causal_conv1d, conv_transpose1d_trim, elu

    y = conv_transpose1d_trim(x, wu, bu, 5)
    h = causal_conv1d(elu(causal_conv1d(elu(y), w1, b1)), w2, b2)
    return elu(y + h)


MIXED_STARTS = [0, 1, 2, 4, 5, 96, 960, 1537]


def _check_stream_lanes(gen, shape, weights, dtype) -> float:
    """Kernel 8's stream form against its plain version at ``shape`` with a
    seeded halo and per-lane starts (mixed when there are several lanes),
    bit-equal over two calls; returns the max abs error."""
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    x, halo = _seanet_x(gen, shape, dtype), _seanet_x(gen, (shape[0], 256, st.HALO), dtype)
    starts = MIXED_STARTS[: shape[0]] if shape[0] > 1 else [shape[2]]
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    err = _check_one(
        "fused_up2_up3_tail_stream",
        lambda xx, *ws: st.fused_up2_up3_tail_stream(xx, halo, start, *ws),
        lambda xx, *ws: st.fused_up2_up3_tail_stream_plain(xx, halo, start, *ws),
        x, weights, dtype, (shape[0], 1, 20 * shape[2]),
    )
    print(f"  fused_up2_up3_tail_stream {dname(dtype)} x={tuple(shape)} starts {starts}: "
          f"max_abs_err {err:.3e}, bit-equal over two calls  [{CARD}]")
    return err


def check_up2(rows: dict) -> None:
    """Kernel 7 at 160 frames (x [1,256,15360]; on tensor cores in bf16)
    and at the harvest shape (8 lanes x 256 frames) beside its op chain;
    kernel 8 (on tensor cores in bf16) whole at 160 frames, bit-equal over
    two calls, streamed in 16-frame blocks with a carried halo, and at 8
    lanes of mixed starts in blocks of 4 and 8 frames; one streamed block timed at 4, 8 and 16 frames,
    each size beside its yardstick, kernel 7 then kernel 2 on the same x
    (one graph): a fused kernel slower than that pair does not pay."""
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    frames, block = 160, 16 * 96
    t_in = 96 * frames
    t_out = 1920 * frames
    for dtype in (torch.float32, torch.bfloat16):
        up2, rest = _up2_inputs(gen, dtype)
        shapes = [(1, 256, t_in)] + ([(8, 256, 96 * 256)] if dtype == torch.bfloat16 else [])
        for shape in shapes:
            x = _seanet_x(gen, shape, dtype)
            what = f"fused_up2_res {dname(dtype)} x={shape}"
            per_graph = 5 if shape[0] == 1 else 2
            err = _check_one("fused_up2_res", st.fused_up2_res, st.fused_up2_res_plain, x, up2, dtype,
                             (shape[0], 128, 5 * shape[2]))
            ms = device_ms(lambda: st.fused_up2_res(x, *up2), per_graph=per_graph)
            plain_ms = device_ms(lambda: st.fused_up2_res_plain(x, *up2), per_graph=per_graph)
            chain_ms = device_ms(lambda: _up2_op_chain(x, *up2), per_graph=per_graph)
            b_ms, b_by = seanet_bound("fused_up2_res", shape, up2, dtype)
            design = f" (SIMT design {SEANET_DESIGN['fused_up2_res']:.4f} ms)" if dtype == torch.bfloat16 and shape[0] == 1 else ""
            print(
                f"  {what}: max_abs_err {err:.3e}, bit-equal over two calls  kernel {ms:.4f} ms{design}  "
                f"plain {plain_ms:.4f} ms  op chain of mimi_decode {chain_ms:.4f} ms (kernel below it: "
                f"{'yes' if ms < chain_ms else 'no'})  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
            )
            if dtype != torch.bfloat16:
                continue
            if shape[0] == 1:
                rows["fused_up2_res"].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    op_chain_ms=chain_ms,
                )
            else:
                rows["fused_up2_res"].update(harvest_ms=ms, harvest_bound_ms=b_ms, harvest_op_chain_ms=chain_ms)
                rows["fused_up2_res"]["max_abs_err"] = max(rows["fused_up2_res"]["max_abs_err"], err)

        x = _seanet_x(gen, (1, 256, t_in), dtype)
        weights = up2 + rest
        err = _check_one("fused_up2_up3_tail", st.fused_up2_up3_tail, st.fused_up2_up3_tail_plain, x, weights, dtype,
                         (1, 1, t_out))
        want = st.fused_up2_up3_tail_plain(x, *weights)
        what = f"fused_up2_up3_tail {dname(dtype)} x={tuple(x.shape)}"
        err8 = 0.0
        for n in (4, 8):  # 8: the batched stream decode's block at the serving settings
            err8 = max(err8, _check_stream_lanes(gen, (8, 256, 96 * n), weights, dtype))
        halo = torch.zeros((1, 256, st.HALO), dtype=dtype, device="cuda")
        start = torch.zeros((1,), dtype=torch.int32, device="cuda")
        blocks = []
        for pos in range(0, t_in, block):
            xb = x[:, :, pos : pos + block].contiguous()
            blocks.append(st.fused_up2_up3_tail_stream(xb, halo, start, *weights))
            halo = torch.cat([halo, xb], dim=2)[:, :, -st.HALO :].contiguous()
            start = start + block
        err_stream = max_err(torch.cat(blocks, dim=2), want, dtype, what + f" streamed in blocks of {block}")
        ms = device_ms(lambda: st.fused_up2_up3_tail(x, *weights), per_graph=3)
        block_ms, yard_ms = {}, {}
        for n in (4, 8, 16, 160):  # the stream decoder's segments, then the whole form
            xb = x[:, :, : 96 * n].contiguous()
            if n < 160:
                start = torch.full((1,), 96 * n, dtype=torch.int32, device="cuda")
                block_ms[n] = device_ms(lambda: st.fused_up2_up3_tail_stream(xb, halo, start, *weights), per_graph=5)
            yard_ms[n] = device_ms(lambda: st.fused_seanet_up_tail(st.fused_up2_res(xb, *up2), *rest),
                                   per_graph=5 if n < 160 else 3)
        plain_ms = device_ms(lambda: st.fused_up2_up3_tail_plain(x, *weights), per_graph=3)
        b_ms, b_by = seanet_bound("fused_up2_up3_tail", tuple(x.shape), weights, dtype)
        bf16 = dtype == torch.bfloat16
        # The streamed decode's last stages (kernel 8, no rounding between
        # stages) against the one-shot decode's (kernel 7, its output in the
        # activation dtype, then kernel 2) on the same x.
        diff = (st.fused_up2_up3_tail(x, *weights).float()
                - st.fused_seanet_up_tail(st.fused_up2_res(x, *up2), *rest).float())
        print(f"  {what}: kernel 8 - (kernel 7 then kernel 2): max abs {diff.abs().max().item():.3e}, "
              f"RMS {diff.pow(2).mean().sqrt().item():.3e}, max |out| {want.float().abs().max().item():.3f}  [{CARD}]")
        design = f" (SIMT design {SEANET_DESIGN['fused_up2_up3_tail']:.4f} ms)" if bf16 else ""
        blocks_txt = ", ".join(
            f"{n} frames {v:.4f} ms" + (f" (SIMT design {CASCADE_BLOCK_DESIGN[n]:.4f})" if bf16 else "")
            + f", kernels 7 + 2 {yard_ms[n]:.4f} ms"
            for n, v in block_ms.items()
        )
        print(
            f"  {what}: max_abs_err {err:.3e} (streamed {err_stream:.3e}), bit-equal over two calls  "
            f"kernel {ms:.4f} ms{design}, kernels 7 + 2 {yard_ms[160]:.4f} ms (fusion pays: "
            f"{'yes' if ms < yard_ms[160] else 'no'})  one streamed block: {blocks_txt}  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
        )
        if bf16:
            rows["fused_up2_up3_tail"].update(
                max_abs_err=max(err, err_stream, err8), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, block_ms=block_ms, yardstick_ms=yard_ms,
            )


def path_device_times(rows: dict, path_shapes: dict = PATH_SHAPES, key: str = "path") -> None:
    """Each SEANet kernel's device time on the paths of ``path_shapes``
    (phases 3, 5, 7 and 9, or phase 12's): every (kernel, input shape)
    those paths launched, re-timed by CUDA-graph replay on seeded bf16
    inputs, times its count; beside the bound at the same shapes, into the
    kernel table under ``{key}_ms``, ``{key}_bound_ms`` and
    ``{key}_shapes``. Kernel 8 is timed in its streaming form, and first
    held against its plain version at each of its shapes (mixed per-lane
    starts where the shape has several lanes)."""
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    dtype = torch.bfloat16
    up2, rest = _up2_inputs(gen, dtype)
    weights = {
        "fused_seanet_up_tail": rest,
        "fused_seanet_tail": rest[2:],
        "fused_up2_res": up2,
        "fused_up2_up3_tail": up2 + rest,
    }
    totals: dict = {}
    for (name, shape), n in sorted(path_shapes.items()):
        x, ws = _seanet_x(gen, shape, dtype), weights[name]
        if name == "fused_up2_up3_tail":
            _check_stream_lanes(gen, shape, ws, dtype)
            halo = torch.zeros((shape[0], 256, st.HALO), dtype=dtype, device="cuda")
            start = torch.full((shape[0],), shape[2], dtype=torch.int32, device="cuda")

            def call():
                return st.fused_up2_up3_tail_stream(x, halo, start, *ws)
        else:
            kernel = getattr(st, name)

            def call():
                return kernel(x, *ws)
        ms = device_ms(call, per_graph=5 if shape[0] * shape[2] <= 96 * 256 else 2)
        b_ms, _ = seanet_bound(name, shape, ws, dtype)
        print(f"  {name} x={shape}: {n} launches on the paths, {ms:.5f} ms a call, bound {b_ms:.5f} ms")
        tot = totals.setdefault(name, [0, 0.0, 0.0])
        tot[0] += n
        tot[1] += n * ms
        tot[2] += n * b_ms
    for name, (n, ms, b_ms) in totals.items():
        print(f"  {name}: device time on the paths {ms:.4f} ms over {n} launches, bound {b_ms:.5f} ms  [{CARD}]")
        shapes = [[*shape, count] for (kname, shape), count in sorted(path_shapes.items()) if kname == name]
        rows[name].update({f"{key}_ms": ms, f"{key}_bound_ms": b_ms, f"{key}_shapes": shapes})


def check_batched_decode_attention(rows: dict) -> None:
    """Kernel 4's attention-only entries (the Pallas kernel's counterparts)
    at random lane offsets and at the split boundaries, and the fused step
    the batcher runs (RoPE, row quantization and row write, then the same
    attention), whose written rows and scales must be bit-equal to its
    plain version's."""
    from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
    from go_pocket_tts_tpu_torch.kernels.split_kv import boundary_offsets
    from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows
    from go_pocket_tts_tpu_torch.ops import build_rope_tables

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_layers, b, h, c, d, layer = 6, 8, 16, 384, 64, 3
    offsets = torch.randint(0, c, (b,), generator=gen, device="cuda", dtype=torch.int32)
    offsets[0] = c - 1  # one lane reads its whole cache
    visible = int((offsets.long() + 1).sum())  # rows a head reads, over the lanes
    lane_mask = (torch.arange(c, device="cuda")[None, :] <= offsets.long()[:, None])[:, None, None, :]
    cos, sin = (t.cuda() for t in build_rope_tables(8192, d))
    # Lanes 1..7 of each set take the boundary offsets; lane 0 reads all.
    edges = boundary_offsets(c, b * h)
    edge_sets = [
        torch.tensor(([c - 1] + edges[i : i + b - 1] + [0] * b)[:b], dtype=torch.int32, device="cuda")
        for i in range(0, len(edges), b - 1)
    ]
    print(f"  batched decode attention: lane offsets {offsets.tolist()}; boundary offsets {edges}")
    for int8 in (False, True):
        name = "batched_decode_attention_int8" if int8 else "batched_decode_attention"
        kernel, plain = getattr(bda, name), getattr(bda, name + "_plain")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(dtype)
            k, v = ((torch.randn((n_layers, b, h, c, d), generator=gen, device="cuda") * 0.3).to(dtype) for _ in range(2))
            if int8:
                (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                bufs, buf_names = [kq, ks, vq, vs], ("k", "k_scale", "v", "v_scale")

                def attend(offs):
                    return (q, kq, ks, vq, vs, offs, layer)
            else:
                bufs, buf_names = [k, v], ("k", "v")

                def attend(offs):
                    return (q, k, v, offs, layer)
            what = f"{name} {dname(dtype)} B={b} H={h} C={c}"
            args = attend(offsets)
            err = max_err(kernel(*args), plain(*args), dtype, what)
            for offs in edge_sets:
                err = max(err, max_err(kernel(*attend(offs)), plain(*attend(offs)), dtype, f"{what} offsets {offs.tolist()}"))
            ms, plain_ms = device_ms(lambda: kernel(*args)), device_ms(lambda: plain(*args))
            lib_ms = None
            if not int8:  # yardstick: SDPA with a per-lane boolean mask
                lib_ms = device_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(q, k[layer], v[layer], attn_mask=lane_mask)
                )
            es = torch.finfo(dtype).bits // 8
            row_bytes = d * (1 if int8 else es) + (4 if int8 else 0)  # + its row scale
            bytes_moved = 2 * es * b * h * d + 4 * b + 2 * h * visible * row_bytes
            b_ms, b_by = bound(bytes_moved, 4.0 * h * visible * d, dtype)
            lib = "none" if lib_ms is None else f"{lib_ms:.5f} ms"
            first = f" (first design {FIRST_DESIGN_MS[name]:.5f} ms)" if dtype == torch.bfloat16 else ""
            print(
                f"  {what}: max_abs_err {err:.3e}  kernel {ms:.5f} ms{first}  plain {plain_ms:.5f} ms  "
                f"sdpa {lib}  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
            )

            # The fused step, with q, k_new, v_new views into one QKV projection.
            qv, kv, vv = torch.randn((b, 1, 3 * h * d), generator=gen, device="cuda").to(dtype).reshape(
                b, 1, 3, h, d
            ).permute(2, 0, 3, 1, 4)

            def step(fn, bb, offs):
                scales = (bb[1], bb[3]) if int8 else (None, None)
                kc, vc = (bb[0], bb[2]) if int8 else (bb[0], bb[1])
                return fn(qv, kv, vv, kc, vc, offs, cos, sin, layer, *scales)

            step_err = 0.0
            for offs in [offsets] + edge_sets:
                mine, ref = [x.clone() for x in bufs], [x.clone() for x in bufs]
                got = step(bda.batched_decode_attention_step, mine, offs)
                want = step(bda.batched_decode_attention_step_plain, ref, offs)
                step_err = max(step_err, max_err(got, want, dtype, f"{what} fused step offsets {offs.tolist()}"))
                for buf_name, x, y in zip(buf_names, mine, ref):
                    if not torch.equal(x, y):
                        fail(f"{what} fused step: {buf_name} not bit-equal to the plain version's ({offs.tolist()})")
            step_ms = device_ms(lambda: step(bda.batched_decode_attention_step, mine, offsets))
            step_plain_ms = device_ms(lambda: step(bda.batched_decode_attention_step_plain, ref, offsets))
            print(
                f"  {what} fused step (RoPE, {'row quantization, ' if int8 else ''}row write, attention): "
                f"max_abs_err {step_err:.3e}, written {'/'.join(buf_names)} bit-equal to plain  "
                f"kernel {step_ms:.5f} ms (attention alone {ms:.5f} ms)  plain {step_plain_ms:.5f} ms  [{CARD}]"
            )
            if dtype == torch.bfloat16:
                rows[name].update(
                    max_abs_err=max(err, step_err), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, fused_step_ms=step_ms, fused_step_plain_ms=step_plain_ms,
                )


# The int8 linears of a batched AR step that pass the kernel's gate, (K, N)
# of real_arch(): FlowLM in_proj, out_proj, linear1, linear2; flowNet
# cond_embed and mlp2 (1024 -> 512), mlp0, and the fused adaLN projection.
QMM_SHAPES = (
    ("in_proj", 1024, 3072),
    ("out_proj", 1024, 1024),
    ("linear1", 1024, 4096),
    ("linear2", 4096, 1024),
    ("cond_embed/mlp2", 1024, 512),
    ("mlp0", 512, 1024),
    ("fused_adaln", 512, 10240),
)


def int8pack_call(x, w, scale):
    """``torch._weight_int8pack_mm`` on these inputs (the weight transposed
    once to its ``[N, K]`` layout, the scale in x's dtype) as a callable, and
    a note; ``(None, reason)`` where this torch has no CUDA kernel for it.
    Timed as kernel 5's library call; the port never calls it."""
    wt, s = w.t().contiguous(), scale.to(x.dtype)

    def call():
        return torch._weight_int8pack_mm(x, wt, s)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"none (no CUDA kernel in torch {torch.__version__}: {str(e).splitlines()[0][:100]})"
    return call, "torch._weight_int8pack_mm"


def int4pack_call(x, w, scale):
    """``torch._weight_int4pack_mm`` on kernel 6's inputs: the levels as
    unsigned nibbles (level + 8) of an ``[N, K]`` weight, packed by
    ``torch._convert_weight_to_int4pack``, group size 128, the scale beside
    zero points 0. ``(None, reason)`` where it cannot run on the card. Timed
    as kernel 6's library call; the port never calls it."""
    from go_pocket_tts_tpu_torch.models.quantize import depack_int4_pairs

    k, n = 2 * w.shape[0], w.shape[1]
    if x.dtype != torch.bfloat16:
        return None, "none (bfloat16 only)"
    q = (depack_int4_pairs(w).reshape(k, n).to(torch.int32) + 8).t().contiguous()  # [N, K] in 0..15
    packed = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8)
    sz = torch.stack([scale.to(torch.bfloat16), torch.zeros_like(scale, dtype=torch.bfloat16)], dim=-1).contiguous()
    try:
        wp = torch.ops.aten._convert_weight_to_int4pack(packed, 8)  # 8 inner k tiles

        def call():
            return torch.ops.aten._weight_int4pack_mm(x, wp, 128, sz)

        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"none (no CUDA kernel in torch {torch.__version__}: {str(e).splitlines()[0][:100]})"
    return call, "torch._weight_int4pack_mm"


def check_quantized_matmul(rows: dict) -> None:
    from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm
    from go_pocket_tts_tpu_torch.kernels.split_k import matmul_plan

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for m in (1, 8, 64):
        for label, k, n in QMM_SHAPES:
            for dtype in (torch.bfloat16, torch.float32) if m == 8 else (torch.bfloat16,):
                x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
                scale = torch.rand((n,), generator=gen, device="cuda") * 1e-3 + 1e-4
                bias = torch.randn((n,), generator=gen, device="cuda").to(dtype)
                plan = matmul_plan(m, k, n, x.element_size())
                what = f"quantized_matmul {label} {dname(dtype)} M={m} K={k} N={n}"
                # The float32 product: both are float32 sums of exact products,
                # the float32 tolerance. The fused form (apply_linear's: rounded
                # to x's dtype, the bias added in it): x's dtype's tolerance.
                got = qmm.quantized_matmul(x, w, scale)
                fused = qmm.quantized_matmul(x, w, scale, bias, dtype)
                err = max_err(got, qmm.quantized_matmul_plain(x, w, scale), torch.float32, what)
                fused_err = max_err(fused, qmm.quantized_matmul_plain(x, w, scale, bias, dtype), dtype, what + " +bias")
                if not (torch.equal(qmm.quantized_matmul(x, w, scale), got)
                        and torch.equal(qmm.quantized_matmul(x, w, scale, bias, dtype), fused)):
                    fail(f"{what}: two calls are not bit-equal")
                ms = device_ms(lambda: qmm.quantized_matmul(x, w, scale))
                fused_ms = device_ms(lambda: qmm.quantized_matmul(x, w, scale, bias, dtype))
                plain_ms = device_ms(lambda: qmm.quantized_matmul_plain(x, w, scale))
                lib_call, lib_note = int8pack_call(x, w, scale)
                lib_ms = device_ms(lib_call) if lib_call else None
                # Yardstick: a matmul against a pre-dequantized weight of x's
                # dtype, twice the bytes.
                w_deq = (w.float() * scale).to(dtype)
                deq_ms = device_ms(lambda: torch.matmul(x, w_deq))
                es = torch.finfo(dtype).bits // 8
                b_ms, b_by = bound(k * n + es * m * k + 4 * n + 4 * m * n, 2.0 * m * k * n, dtype)
                key = (label, m, dtype) == ("linear1", 8, torch.bfloat16)
                first = f" (first design {FIRST_DESIGN_MS['quantized_matmul']:.5f} ms)" if key else ""
                lib = f"{lib_ms:.5f} ms" if lib_ms is not None else lib_note
                print(
                    f"  {what} [BN {plan.block_n}, S {plan.splits}]: max_abs_err {err:.3e} (+bias {fused_err:.3e}), "
                    f"bit-equal twice  kernel {ms:.5f} ms{first} (+bias, {dname(dtype)} out {fused_ms:.5f} ms)  "
                    f"plain {plain_ms:.5f} ms  int8pack_mm {lib}  matmul(dequantized {dname(dtype)}) {deq_ms:.5f} ms  "
                    f"bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
                )
                if key:
                    rows["quantized_matmul"].update(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        library=lib_note, fused_ms=fused_ms,
                        fused_max_abs_err=fused_err, dequantized_matmul_ms=deq_ms,
                    )


def check_int4_matmul(rows: dict) -> None:
    from go_pocket_tts_tpu_torch.kernels import int4_matmul as i4mm
    from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm
    from go_pocket_tts_tpu_torch.kernels.split_k import matmul_plan
    from go_pocket_tts_tpu_torch.models.quantize import dequantize_weight

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for m in (1, 8, 64):
        for label, k, n in QMM_SHAPES:
            for dtype in (torch.bfloat16, torch.float32) if m == 8 else (torch.bfloat16,):
                x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
                # Random bytes: every nibble code, -8 included, appears.
                w = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda", dtype=torch.uint8)
                scale = torch.rand((k // 128, n), generator=gen, device="cuda") * 1e-3 + 1e-4
                bias = torch.randn((n,), generator=gen, device="cuda").to(dtype)
                plan = matmul_plan(m, k, n, x.element_size(), w_bits=4)
                what = f"int4_matmul {label} {dname(dtype)} M={m} K={k} N={n}"
                # The float32 product: both are float32 sums of exact products,
                # the float32 tolerance. The fused form (apply_linear's: rounded
                # to x's dtype, the bias added in it): x's dtype's tolerance.
                got = i4mm.int4_matmul(x, w, scale)
                fused = i4mm.int4_matmul(x, w, scale, bias, dtype)
                err = max_err(got, i4mm.int4_matmul_plain(x, w, scale), torch.float32, what)
                fused_err = max_err(fused, i4mm.int4_matmul_plain(x, w, scale, bias, dtype), dtype, what + " +bias")
                if not (torch.equal(i4mm.int4_matmul(x, w, scale), got)
                        and torch.equal(i4mm.int4_matmul(x, w, scale, bias, dtype), fused)):
                    fail(f"{what}: two calls are not bit-equal")
                ms = device_ms(lambda: i4mm.int4_matmul(x, w, scale))
                fused_ms = device_ms(lambda: i4mm.int4_matmul(x, w, scale, bias, dtype))
                plain_ms = device_ms(lambda: i4mm.int4_matmul_plain(x, w, scale))
                lib_call, lib_note = int4pack_call(x, w, scale)
                lib_ms = device_ms(lib_call) if lib_call else None
                lib = lib_note
                if lib_call:
                    lib_err = (lib_call().float() - i4mm.int4_matmul_plain(x, w, scale)).abs().max().item()
                    lib = f"{lib_ms:.5f} ms, bf16 out, against the fused bf16-out {fused_ms:.5f} ms (max_abs_err against plain {lib_err:.3e})"
                # Yardsticks: a matmul against the pre-dequantized weight in x's
                # dtype (four times the bytes in bf16), and kernel 5 on an int8
                # weight of the same shape (twice the bytes).
                w_deq = dequantize_weight({"w": w, "scale": scale}).to(dtype)
                deq_ms = device_ms(lambda: torch.matmul(x, w_deq))
                w8 = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
                s8 = scale[0].contiguous()
                qmm_ms = device_ms(lambda: qmm.quantized_matmul(x, w8, s8))
                es = torch.finfo(dtype).bits // 8
                b_ms, b_by = bound(k * n // 2 + 4 * (k // 128) * n + es * m * k + 4 * m * n, 2.0 * m * k * n, dtype)
                key = (label, dtype) == ("linear1", torch.bfloat16)
                first = f" (first design {FIRST_DESIGN_MS['int4_matmul']:.5f} ms)" if key and m == 8 else ""
                print(
                    f"  {what} [BN {plan.block_n}, S {plan.splits}, R {plan.rows_per_split}]: max_abs_err {err:.3e} "
                    f"(+bias {fused_err:.3e}), bit-equal twice  kernel {ms:.5f} ms{first} (+bias, {dname(dtype)} out "
                    f"{fused_ms:.5f} ms)  plain {plain_ms:.5f} ms  int4pack_mm {lib}  matmul(dequantized "
                    f"{dname(dtype)}) {deq_ms:.5f} ms  int8 kernel 5 {qmm_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by})  [{CARD}]"
                )
                if key and m == 8:
                    rows["int4_matmul"].update(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        library=lib_note, fused_ms=fused_ms,
                        fused_max_abs_err=fused_err, dequantized_matmul_ms=deq_ms,
                    )
                elif key:
                    rows["int4_matmul"][f"ms_m{m}"] = ms


# -- phases 3 to 8: the main paths -------------------------------------------


@functools.lru_cache(maxsize=1)
def checkpoint():
    """``real_arch()`` float32 weights from the fixed seed, ``{name: array}``."""
    from go_pocket_tts_tpu_torch.models import synthetic

    arch = synthetic.real_arch()
    return arch, synthetic.build_checkpoint(arch, seed=SEED)


def build_model(dtype: torch.dtype):
    from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors

    arch, tensors = checkpoint()
    return arch, load_model_from_tensors(tensors, num_heads=arch.num_heads, device="cuda", dtype=dtype)


def check_audio(audio: np.ndarray, frames: int, what: str, bounded: bool = True) -> None:
    """Float32 PCM of ``frames`` latent frames, finite and not silent; within
    [-1, 1] when ``bounded`` (the one-shot paths clamp, the streamed blocks
    are the decoder's PCM as it comes)."""
    if audio.dtype != np.float32 or audio.shape != (frames * 1920,):
        fail(f"{what}: audio {audio.dtype} {audio.shape}, want float32 ({frames * 1920},)")
    if not np.isfinite(audio).all() or (bounded and np.abs(audio).max() > 1.0):
        fail(f"{what}: audio not finite or outside [-1, 1]")
    if not np.abs(audio).max() > 0:
        fail(f"{what}: silent audio")


def read_launches(phase: str, must, counts: dict, shapes=PATH_SHAPES) -> None:
    """Read every launch count after a path's run (they were set to 0 just
    before it), fail if a kernel the path runs was not launched, and add the
    counts to ``counts`` (and, unless ``shapes`` is None, the SEANet
    kernels' counts by input shape to ``shapes``)."""
    from go_pocket_tts_tpu_torch import kernels

    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    print(f"  launches in {phase}: {launches}")
    for fn in kernels.WRAPPERS if shapes is not None else ():
        for shape, n in getattr(fn, "shapes", {}).items():
            shapes[(fn.__name__, shape)] = shapes.get((fn.__name__, shape), 0) + n
    for name in must:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched in {phase}")
    for name, n in launches.items():
        counts[name] = counts.get(name, 0) + n


def main_requests(arch):
    """The 12-, 24- and 45-token requests of phases 3 and 9, with their
    temperatures."""
    rng = np.random.RandomState(SEED)
    return [(rng.randint(0, arch.n_bins, size=n).tolist(), temp) for n, temp in ((12, 0.0), (24, 0.7), (45, 0.7))]


def main_path(model, arch, counts: dict) -> None:
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames

    rt = GPURuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda")
    requests = main_requests(arch)
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
    read_launches(
        "the single-utterance path",
        ("decode_attention_step", "fused_up2_res", "fused_seanet_up_tail", "fused_seanet_tail"),
        counts,
    )


def serve_requests(batcher, reqs, cfg, what: str, must, counts: dict) -> float:
    """Warm the started batcher up on one request, then submit ``reqs`` at
    once with every launch count set to 0; check the audio and the path's
    launches, print and return the aggregate x real time."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames

    t = time.perf_counter()
    batcher.generate(reqs[0], cfg, timeout=300)  # warm-up
    print(f"  {what}: warmed up in {time.perf_counter() - t:.1f} s")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    futs = [batcher.submit(tokens, cfg) for tokens in reqs]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t
    read_launches(f"the {what} path", must, counts)
    for i, (tokens, audio) in enumerate(zip(reqs, outs)):
        check_audio(audio, estimate_max_frames(len(tokens)), f"{what} request {i}")
    secs = sum(len(a) for a in outs) / 24000
    x_real = secs / wall
    print(
        f"  {what}: {len(reqs)} requests of {min(map(len, reqs))}-{max(map(len, reqs))} tokens, "
        f"{secs:.2f} s of audio in {wall * 1e3:.1f} ms wall: x{x_real:.2f} real time aggregate  [{CARD}]"
    )
    return x_real


def serving_requests(arch):
    """The 16 requests of phases 5 and 7 (12-45 tokens) and their config."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig

    rng = np.random.RandomState(SEED + 4)
    requests = [rng.randint(0, arch.n_bins, size=n).tolist() for n in rng.randint(12, 46, size=16)]
    return requests, GenerateConfig(temperature=0.7, eos_threshold=1e9)


def batched_serving(model, arch, counts: dict) -> float:
    """Phase 5; returns the int8-KV run's aggregate x real time."""
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher

    requests, cfg = serving_requests(arch)
    x_int8 = None
    for kv_quantize, reqs in ((True, requests), (False, requests[:4])):
        attention = "batched_decode_attention_int8" if kv_quantize else "batched_decode_attention"
        what = f"batcher slots=8 int8 weights, {'int8' if kv_quantize else 'bf16'} KV cache"
        batcher = ContinuousBatcher(
            model, slots=8, prompt_capacity=128, max_frames=256, dtype=torch.bfloat16, seed=SEED,
            steps_per_sync=8, steps_per_sync_burst=64, quantize=True, kv_quantize=kv_quantize, device="cuda",
        )
        batcher.start()
        try:
            must = (attention, "quantized_matmul", "fused_up2_res", "fused_seanet_up_tail")
            x_real = serve_requests(batcher, reqs, cfg, what, must, counts)
        finally:
            batcher.stop()
        x_int8 = x_real if kv_quantize else x_int8
        del batcher
    torch.cuda.empty_cache()
    return x_int8


def plain_versions():
    """Swap every kernel wrapper for its plain version (module attributes the
    model code reads at call time); returns the undo function."""
    from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
    from go_pocket_tts_tpu_torch.kernels import decode_attention as da
    from go_pocket_tts_tpu_torch.kernels import int4_matmul as i4mm
    from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    saved = [
        (da, "decode_attention_step", da.decode_attention_step_plain),
        (st, "fused_seanet_up_tail", st.fused_seanet_up_tail_plain),
        (st, "fused_seanet_tail", st.fused_seanet_tail_plain),
        (bda, "batched_decode_attention", bda.batched_decode_attention_plain),
        (bda, "batched_decode_attention_int8", bda.batched_decode_attention_int8_plain),
        (bda, "batched_decode_attention_step", bda.batched_decode_attention_step_plain),
        (qmm, "quantized_matmul", qmm.quantized_matmul_plain),
        (i4mm, "int4_matmul", i4mm.int4_matmul_plain),
        (st, "fused_up2_res", st.fused_up2_res_plain),
        (st, "fused_up2_up3_tail", st.fused_up2_up3_tail_plain),
        (st, "fused_up2_up3_tail_stream", st.fused_up2_up3_tail_stream_plain),
    ]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in saved]
    for mod, attr, plain in saved:
        setattr(mod, attr, plain)

    def undo():
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)

    return undo


def rms_check(a: np.ndarray, b: np.ndarray, what: str, tol: float = PATH_RMS_TOL) -> float:
    rms = float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))
    print(f"  {what}: RMS {rms:.3e} (tolerance {tol})  [{CARD}]")
    if not rms < tol:
        fail(f"{what}: RMS {rms} beyond {tol}")
    return rms


def f32_parity(model, arch) -> None:
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

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
    rms_check(a, b, "f32 real_arch, 40 frames, kernels - plain")


def parity_requests(arch):
    """A 20-token request, a neighbour lane of 33 tokens at another offset,
    40 frames at temperature 0."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig

    rng = np.random.RandomState(SEED + 2)
    tokens = rng.randint(0, arch.n_bins, size=20).tolist()
    other = rng.randint(0, arch.n_bins, size=33).tolist()
    return tokens, other, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=40)


def serve_f32(model, arch, **kw) -> np.ndarray:
    """The parity request served next to its neighbour by a float32 8-slot
    batcher with the knobs ``kw``; returns the parity request's audio."""
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher

    tokens, other, cfg = parity_requests(arch)
    batcher = ContinuousBatcher(
        model, slots=8, prompt_capacity=128, max_frames=256, dtype=torch.float32, seed=SEED, device="cuda", **kw
    )
    batcher.start()
    try:
        futs = [batcher.submit(tokens, cfg), batcher.submit(other, cfg)]
        out = futs[0].result(timeout=300)
        futs[1].result(timeout=300)
    finally:
        batcher.stop()
    check_audio(out, 40, f"f32 batcher {kw}")
    return out


def f32_batched_parity(model, arch) -> float:
    """Returns the int8 batcher's kernels-vs-plain RMS."""
    from go_pocket_tts_tpu_torch.runtime import GPURuntime

    tokens, _, cfg = parity_requests(arch)
    single = GPURuntime(model, dtype=torch.float32, seed=SEED, device="cuda").generate_audio(tokens, cfg)
    rms_check(serve_f32(model, arch), single, "f32 real_arch, 40 frames, batcher - single runtime")
    q_kernels = serve_f32(model, arch, quantize=True, kv_quantize=True)
    undo = plain_versions()
    try:
        q_plain = serve_f32(model, arch, quantize=True, kv_quantize=True)
    finally:
        undo()
    return rms_check(q_kernels, q_plain, "f32 real_arch, 40 frames, int8 weights + int8 KV batcher, kernels - plain")


def _assert_same_tree(got, want, what: str) -> int:
    """Leaf for leaf the same dtype and values (RoPE tables, rebuilt by
    torch's CPU cos, within 1e-5); returns the number of packed int4
    leaves."""
    from go_pocket_tts_tpu_torch.models.params import tree_map

    def leaves(tree):
        out = {}
        tree_map(lambda path, leaf: out.__setitem__(".".join(path), leaf), tree)
        return out

    a, b = leaves(got), leaves(want)
    if set(a) != set(b):
        fail(f"{what}: leaves differ: {sorted(set(a) ^ set(b))[:6]}")
    for name, x in a.items():
        y = b[name]
        same = x.dtype == y.dtype and x.shape == y.shape and (
            bool(((x - y).abs() <= 1e-5).all()) if "rope_" in name else torch.equal(x, y)
        )
        if not same:
            fail(f"{what}: leaf {name} differs ({x.dtype} {tuple(x.shape)} vs {y.dtype} {tuple(y.shape)})")
    return sum(x.dtype == torch.uint8 for x in a.values())


def int4_serving(model32, arch, counts: dict, x_int8: float):
    """Phase 7; returns the artifact loaded in float32 for phase 8."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
    from go_pocket_tts_tpu_torch.kernels import int4_matmul as i4mm
    from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint
    from go_pocket_tts_tpu_torch.models.model import load_model
    from go_pocket_tts_tpu_torch.models.quantize import model_quantized_bits, quantize_model_params
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames
    from go_pocket_tts_tpu_torch.utils.safetensors import read_header_metadata, write_file

    _, tensors = checkpoint()
    t = time.perf_counter()
    q_tensors, meta, quantized = build_quantized_checkpoint(tensors, 4, num_heads=arch.num_heads)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = os.path.join(tmp, "int4.safetensors")
        write_file(path, q_tensors, metadata=meta)
        size = os.path.getsize(path)
        stamp = read_header_metadata(path).get("pockettts.quantize")
        model4_f32 = load_model(path, num_heads=arch.num_heads, device="cuda", dtype=torch.float32)
        model4 = load_model(path, num_heads=arch.num_heads, device="cuda", dtype=torch.bfloat16)
    print(
        f"  exported {len(quantized)} linears as int4 ({stamp}), {size / 1e6:.1f} MB written "
        f"({sum(a.nbytes for a in tensors.values()) / 1e6:.1f} MB float32 source), loaded twice, "
        f"in {time.perf_counter() - t:.1f} s"
    )
    if stamp != "int4-g128" or model_quantized_bits(model4.params) != 4:
        fail(f"int4 artifact: stamp {stamp!r}, bits {model_quantized_bits(model4.params)}")
    with torch.no_grad():
        n_packed = _assert_same_tree(
            model4_f32.params, quantize_model_params(model32.params, bits=4), "int4 artifact vs quantize_model_params"
        )
    print(f"  artifact tree leaf-equal to quantize_model_params(bits=4) of the float32 model ({n_packed} packed leaves)")

    requests, cfg = serving_requests(arch)
    batcher = ContinuousBatcher(
        model4, slots=8, prompt_capacity=128, max_frames=256, dtype=torch.bfloat16, seed=SEED,
        steps_per_sync=8, steps_per_sync_burst=64, kv_quantize=True, device="cuda",
    )
    batcher.start()
    try:
        what = "batcher slots=8 int4 weights (artifact), int8 KV cache"
        must = ("int4_matmul", "batched_decode_attention_int8", "fused_up2_res", "fused_seanet_up_tail")
        x_int4 = serve_requests(batcher, requests, cfg, what, must, counts)
    finally:
        batcher.stop()
    # Kernel 4 runs once per layer of every batched AR step and nowhere else;
    # every AR step makes 38 int4 launches (in_proj, out_proj, linear1 and
    # linear2 of 6 layers; cond_embed, mlp0 and mlp2 of 6 res blocks; the
    # fused adaLN), and a one-lane admission prefill, whose M is its prompt
    # bucket (16-64 rows), makes 24 more (the 6 layers' 4 linears).
    steps = bda.batched_decode_attention_int8.launches // arch.num_layers
    extra = i4mm.int4_matmul.launches - 38 * steps
    print(
        f"  int4 x{x_int4:.2f} real time aggregate against int8 x{x_int8:.2f} (phase 5); {steps} batched AR "
        f"steps: int4_matmul {i4mm.int4_matmul.launches} launches = 38 x {steps} + 24 x {extra // 24} "
        f"(one-lane admission prefills)  [{CARD}]"
    )
    if extra < 0 or extra % 24:
        fail(f"int4 batcher: {i4mm.int4_matmul.launches} int4_matmul launches over {steps} AR steps")
    del batcher

    rt = GPURuntime(model4, dtype=torch.bfloat16, seed=SEED, device="cuda")
    tokens = requests[0]
    rt.generate_audio(tokens[:12], GenerateConfig(temperature=0.7, eos_threshold=1e9))  # warm-up
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    audio = rt.generate_audio(tokens, cfg)
    wall = time.perf_counter() - t
    check_audio(audio, estimate_max_frames(len(tokens)), "int4 single runtime")
    print(
        f"  GPURuntime on the int4 artifact: {len(tokens)} tokens, {len(audio) / 24000:.2f} s of audio "
        f"in {wall * 1e3:.1f} ms: x{len(audio) / 24000 / wall:.2f} real time  [{CARD}]"
    )
    must = ("decode_attention_step", "int4_matmul", "fused_up2_res", "fused_seanet_up_tail")
    read_launches("the int4 single-utterance path", must, counts)
    del rt, model4
    torch.cuda.empty_cache()
    return model4_f32


def f32_int4_parity(model4_f32, arch) -> None:
    q_kernels = serve_f32(model4_f32, arch, kv_quantize=True)
    undo = plain_versions()
    try:
        q_plain = serve_f32(model4_f32, arch, kv_quantize=True)
    finally:
        undo()
    rms_check(q_kernels, q_plain, "f32 real_arch, 40 frames, int4 weights + int8 KV batcher, kernels - plain")


def synthetic_voice_state(arch, frames: int, offset: int):
    """Upstream voice model state from the seed: per layer a ``[2,1,T,H,Dh]``
    K/V cache and its offset."""
    from go_pocket_tts_tpu_torch.utils.safetensors import VoiceModelState

    rng = np.random.RandomState(SEED + 8)
    head_dim = arch.d_model // arch.num_heads
    modules = {
        f"transformer.layers.{i}.self_attn": {
            "cache": (rng.randn(2, 1, frames, arch.num_heads, head_dim) * 0.3).astype(np.float32),
            "offset": np.array([float(offset)], np.float32),
        }
        for i in range(arch.num_layers)
    }
    return VoiceModelState(modules=modules)


def streaming(model, arch, counts: dict) -> None:
    """Phase 9."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate, stream_generate_session
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames

    rt = GPURuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda")
    requests = main_requests(arch)
    for _ in stream_generate(rt, requests[0][0], GenerateConfig(temperature=0.7, eos_threshold=1e9)):  # warm-up
        pass
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i, (tokens, temp) in enumerate(requests):
        cfg = GenerateConfig(temperature=temp, eos_threshold=1e9)
        t = time.perf_counter()
        blocks = stream_generate(rt, tokens, cfg)
        first = next(blocks)
        ttfa = time.perf_counter() - t
        rest = list(blocks)
        wall = time.perf_counter() - t
        audio = np.concatenate([first] + rest)
        frames = estimate_max_frames(len(tokens))
        check_audio(audio, frames, f"streamed request {i}", bounded=False)
        print(
            f"  streamed request {i}: tokens {len(tokens)} temperature {temp} frames {frames} in "
            f"{1 + len(rest)} blocks of {[len(b) // 1920 for b in [first] + rest]} frames: time to first audio "
            f"{ttfa * 1e3:.1f} ms, wall {wall * 1e3:.1f} ms  x{len(audio) / 24000 / wall:.2f} real time  [{CARD}]"
        )
    cont = None
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9)
    for i, (tokens, _temp) in enumerate(requests):
        t = time.perf_counter()
        blocks, next_state = stream_generate_session(rt, tokens, cfg, cont)
        first = next(blocks)
        ttfa = time.perf_counter() - t
        audio = np.concatenate([first] + list(blocks))
        wall = time.perf_counter() - t
        cont = next_state()
        check_audio(audio, estimate_max_frames(len(tokens)), f"streamed session chunk {i}", bounded=False)
        print(
            f"  streamed session chunk {i}: tokens {len(tokens)} time to first audio {ttfa * 1e3:.1f} ms, "
            f"wall {wall * 1e3:.1f} ms  x{len(audio) / 24000 / wall:.2f} real time; carried cache "
            f"{cont.used_ub} of {cont.capacity} slots (offset {int(cont.cache['offset'])})  [{CARD}]"
        )
    read_launches("the streaming path", ("decode_attention_step", "fused_up2_up3_tail"), counts)

    tokens = requests[1][0]
    frames = estimate_max_frames(len(tokens))
    voice = (np.random.RandomState(SEED + 9).randn(1, 32, arch.d_model) * 0.02).astype(np.float32)
    kernels.reset_launches()
    for what, cfg in (
        ("voice embedding [1, 32, 1024]", GenerateConfig(temperature=0.7, eos_threshold=1e9, voice_embedding=voice)),
        (
            "voice model state [2,1,48,16,64] x 6 layers, offset 40",
            GenerateConfig(temperature=0.7, eos_threshold=1e9, voice_model_state=synthetic_voice_state(arch, 48, 40)),
        ),
    ):
        t = time.perf_counter()
        audio = rt.generate_audio(tokens, cfg)
        wall = time.perf_counter() - t
        check_audio(audio, frames, f"generate_audio with a {what}")
        print(f"  generate_audio with a {what}: {len(audio)} samples in {wall * 1e3:.1f} ms  [{CARD}]")
    read_launches("the voiced path", ("decode_attention_step", "fused_up2_res", "fused_seanet_up_tail"), counts)


def f32_streaming(model32, arch) -> None:
    """Phase 10."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate

    tokens, _, _ = parity_requests(arch)
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=40)
    whole = GPURuntime(model32, dtype=torch.float32, seed=SEED).generate_audio(tokens, cfg)
    streamed = np.concatenate(list(stream_generate(GPURuntime(model32, dtype=torch.float32, seed=SEED), tokens, cfg)))
    check_audio(streamed, 40, "f32 streamed", bounded=False)
    # generate_audio clamps to [-1, 1] and truncates to int16; the streamed
    # blocks are the decoder's float PCM.
    clipped = float(np.mean(np.abs(streamed) > 1.0))
    print(f"  f32 streamed PCM: {clipped:.4%} of samples beyond [-1, 1] (clamped before the comparison)")
    rms_check(
        np.clip(streamed, -1.0, 1.0), whole, "f32 real_arch, 40 frames, temperature 0.7, stream_generate - generate_audio"
    )
    undo = plain_versions()
    try:
        plain = np.concatenate(list(stream_generate(GPURuntime(model32, dtype=torch.float32, seed=SEED), tokens, cfg)))
        whole_plain = GPURuntime(model32, dtype=torch.float32, seed=SEED).generate_audio(tokens, cfg)
    finally:
        undo()
    rms_check(streamed, plain, "f32 real_arch, 40 frames, streamed, kernels - plain")
    # Where the one-shot path's kernels-vs-plain RMS (phase 4) stands 40x
    # above the streamed one: each path against its own plain versions, the
    # two plain paths against each other, and the streamed PCM truncated to
    # int16 as generate_audio truncates it.
    rms_check(whole, whole_plain, "f32 real_arch, 40 frames, one-shot, kernels - plain")
    rms_check(np.clip(plain, -1.0, 1.0), whole_plain, "f32 real_arch, 40 frames, plain versions, streamed - one-shot")

    def as_int16(pcm):
        return (np.clip(pcm, -1.0, 1.0) * np.float32(32767.0)).astype(np.int16).astype(np.float32) / 32767.0

    rms_check(as_int16(streamed), as_int16(plain), "f32 real_arch, 40 frames, streamed truncated to int16, kernels - plain")
    print(f"  f32 streamed, kernels - plain: max abs {np.abs(streamed - plain).max():.3e}  [{CARD}]")


# -- phase 11: the entry points ------------------------------------------------

# Texts for the fixture tokenizer: the three sentences of the single
# service's request (31, 25 and 27 tokens: three chunks), the streamed
# requests (12, 24 and 44 tokens, the lengths of phase 3's) and eight
# requests of one chunk each for the batcher.
SERVICE_TEXT = (
    "The quick brown fox jumps over the sleepy dog. Hello world, the brown fox sings a song. "
    "The quick fox walks home to the brown den."
)
STREAM_TEXTS = (
    "Hello world, the quick fox.",
    "Hello world, the quick brown fox jumps high.",
    "The quick brown fox jumps over the lazy dog near the old mill.",
)
BATCH_TEXTS = (
    "Hello world, the quick fox.",
    "Hello world and the brown fox.",
    "The quick brown fox jumps over the sleepy dog.",
    "The brown fox and the quick hound run to the world and back again.",
    "Hello, the quick brown fox jumps over the lazy dog by the river.",
    "Hello world, the brown fox sings a song.",
    "The quick fox walks home to the brown den.",
    "Hello world, the quick brown fox jumps high.",
)


def write_fixture_tokenizer(path: str) -> None:
    """The synthetic SentencePiece tokenizer: seven word pieces and the
    lower-case letters (35 pieces, far below the model's 4001 ids)."""
    from go_pocket_tts_tpu_torch.text.sentencepiece import SentencePieceModel

    sp = SentencePieceModel()
    pieces = [("<unk>", 0.0, 2)] + [(w, -1.0, 1) for w in "▁hello ▁world ▁the ▁quick ▁brown ▁fox .".split()]
    pieces += [(c, -6.0, 1) for c in "abcdefghijklmnopqrstuvwxyz▁"]
    for piece, score, kind in pieces:
        sp.pieces.append(piece)
        sp.scores.append(score)
        sp.types.append(kind)
    with open(path, "wb") as f:
        f.write(sp.serialize())


def entry_fixtures(root: str):
    """The phase-3 seeded checkpoint written as safetensors and the
    synthetic tokenizer, both under the git-ignored ``build/phase11/``;
    returns their paths."""
    from go_pocket_tts_tpu_torch.utils.safetensors import write_file

    out = os.path.join(root, "build", "phase11")
    os.makedirs(out, exist_ok=True)
    model_path = os.path.join(out, "model.safetensors")
    tok_path = os.path.join(out, "tokenizer.model")
    _arch, tensors = checkpoint()
    write_file(model_path, tensors)
    write_fixture_tokenizer(tok_path)
    return model_path, tok_path


def entry_config(model_path: str, tok_path: str, batch_slots: int, temperature: float):
    """The config's defaults (the card), then the fields a deployment sets:
    bfloat16, a seed, and EOS disabled, so each chunk runs its whole
    ``estimate_max_frames`` budget."""
    from go_pocket_tts_tpu_torch.config import Config

    cfg = Config()
    cfg.paths.model_path, cfg.paths.tokenizer_model = model_path, tok_path
    cfg.runtime.dtype, cfg.runtime.seed, cfg.runtime.batch_slots = "bfloat16", SEED, batch_slots
    cfg.tts.temperature, cfg.tts.eos_threshold = temperature, 1e9
    return cfg


def chunk_frames(tokenizer, text: str):
    """(token ids, frames) of each chunk the service cuts ``text`` into."""
    from go_pocket_tts_tpu_torch.text import estimate_max_frames, prepare_chunks
    from go_pocket_tts_tpu_torch.tts.service import MAX_TOKENS_PER_CHUNK

    return [(c.token_ids, estimate_max_frames(c.num_tokens)) for c in prepare_chunks(text, tokenizer, MAX_TOKENS_PER_CHUNK)]


def _post(url: str, text: str, timeout: float = 300.0) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps({"text": text}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            fail(f"POST {url}: status {resp.status}")
        return resp.read()


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        if resp.status != 200:
            fail(f"GET {url}: status {resp.status}")
        return json.loads(resp.read())


def check_wav(body: bytes, frames: int, what: str) -> None:
    from go_pocket_tts_tpu_torch.utils.wav import decode_wav

    pcm, rate = decode_wav(body)
    channels = int.from_bytes(body[22:24], "little")
    if rate != 24000 or channels != 1 or pcm.shape != (frames * 1920,) or not np.abs(pcm).max() > 0:
        fail(f"{what}: {rate} Hz, {channels} channels, {pcm.shape[0]} samples, want 24000 Hz mono {frames * 1920}")


def serve_batcher(model_path: str, tok_path: str) -> None:
    """Eight POST /tts at once to the port's server over the batcher service
    at the serving autotune (int8 weights, int8 KV cache, burst blocks)."""
    from concurrent.futures import ThreadPoolExecutor

    from go_pocket_tts_tpu_torch.config import apply_serving_autotune
    from go_pocket_tts_tpu_torch.server import Server
    from go_pocket_tts_tpu_torch.tts.service import Service

    cfg = entry_config(model_path, tok_path, batch_slots=8, temperature=0.7)
    print(f"  batcher service: autotune {apply_serving_autotune(cfg)}")
    svc = Service.from_config(cfg)
    srv = Server(svc, None, listen_addr="127.0.0.1:0", workers=max(cfg.server.workers, 8), request_timeout=300)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        frames = [chunk_frames(svc.tokenizer, text) for text in BATCH_TEXTS]
        if any(len(f) != 1 for f in frames):
            fail(f"batcher texts: chunks {[len(f) for f in frames]}, want one each")
        _post(f"{url}/tts", BATCH_TEXTS[0])  # warm-up
        with ThreadPoolExecutor(max_workers=len(BATCH_TEXTS)) as pool:
            t = time.perf_counter()
            bodies = list(pool.map(lambda text: _post(f"{url}/tts", text), BATCH_TEXTS))
            wall = time.perf_counter() - t
        secs = 0.0
        for i, (body, f) in enumerate(zip(bodies, frames)):
            check_wav(body, f[0][1], f"batcher POST /tts request {i}")
            secs += f[0][1] * 1920 / 24000
        stats = _get_json(f"{url}/stats")
        if stats["requests_total"] != len(BATCH_TEXTS) + 1 or stats["ok_total"] != len(BATCH_TEXTS) + 1:
            fail(f"batcher server /stats: {stats}")
        print(
            f"  batcher service, POST /tts x{len(bodies)} at once ({[f[0][1] for f in frames]} frames): {secs:.2f} s "
            f"of audio in {wall * 1e3:.1f} ms wall: x{secs / wall:.2f} real time aggregate  [{CARD}]"
        )
    finally:
        srv.shutdown()
        svc.close()


def stream_over_http(url: str, text: str, frames: int, what: str) -> None:
    """POST /tts/stream: time to the first PCM byte after the 44-byte WAV
    header, the PCM length, and the x real time of the whole response."""
    import http.client

    from go_pocket_tts_tpu_torch.utils.wav import streaming_wav_header

    host, port = url.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        t = time.perf_counter()
        conn.request("POST", "/tts/stream", body=json.dumps({"text": text}), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"{what}: status {resp.status}")
        header = resp.read(44)
        if header != streaming_wav_header():
            fail(f"{what}: not the streaming WAV header")
        first = resp.read1(1 << 16)
        ttfb = time.perf_counter() - t
        pcm = first + resp.read()
        wall = time.perf_counter() - t
    finally:
        conn.close()
    if len(pcm) != frames * 1920 * 2:
        fail(f"{what}: {len(pcm) // 2} samples, want {frames * 1920}")
    secs = frames * 1920 / 24000
    print(
        f"  {what}: {frames} frames, first PCM byte after the header {ttfb * 1e3:.1f} ms, wall "
        f"{wall * 1e3:.1f} ms  x{secs / wall:.2f} real time  [{CARD}]"
    )


def single_service(model, model_path: str, tok_path: str) -> None:
    """``Service.synthesize`` of three chunks (the pipelined
    ``generate_audio_async`` route) against ``GPURuntime.generate_audio`` on
    the same chunks at temperature 0; then the port's server over that
    service: POST /tts/stream of three texts (frame streaming, kernel 8),
    GET /health and /stats."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
    from go_pocket_tts_tpu_torch.server import Server
    from go_pocket_tts_tpu_torch.tts.service import Service

    svc = Service.from_config(entry_config(model_path, tok_path, batch_slots=1, temperature=0.0))
    if not isinstance(svc.runtime, GPURuntime) or svc.runtime.dtype != torch.bfloat16:
        fail(f"single service: runtime {type(svc.runtime).__name__}")
    chunks = chunk_frames(svc.tokenizer, SERVICE_TEXT)
    if len(chunks) != 3:
        fail(f"single service text: {len(chunks)} chunks, want 3")
    svc.synthesize(STREAM_TEXTS[0])  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    audio = svc.synthesize(SERVICE_TEXT)
    wall = time.perf_counter() - t
    frames = sum(f for _, f in chunks)
    check_audio(audio, frames, "Service.synthesize")
    rt = GPURuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda")
    want = np.concatenate(
        [rt.generate_audio(ids, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=f)) for ids, f in chunks]
    )
    print(
        f"  Service.synthesize, 3 chunks ({[f for _, f in chunks]} frames) in {wall * 1e3:.1f} ms  "
        f"x{len(audio) / 24000 / wall:.2f} real time; max abs difference to GPURuntime.generate_audio "
        f"{np.abs(audio - want).max():.3e}  [{CARD}]"
    )
    rms_check(audio, want, "bf16 real_arch, Service.synthesize - GPURuntime.generate_audio, temperature 0")

    srv = Server(svc, None, listen_addr="127.0.0.1:0", request_timeout=300)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        for i, text in enumerate(STREAM_TEXTS):
            (_ids, f), = chunk_frames(svc.tokenizer, text)
            stream_over_http(url, text, f, f"single service, POST /tts/stream request {i}")
        health = _get_json(f"{url}/health")
        stats = _get_json(f"{url}/stats")
        if health.get("status") != "ok" or stats["requests_total"] != len(STREAM_TEXTS):
            fail(f"single server: /health {health}, /stats {stats}")
        print(f"  GET /health {health}; GET /stats requests_total {stats['requests_total']}  [{CARD}]")
    finally:
        srv.shutdown()
        svc.close()


def cli_synth(root: str, model_path: str, tok_path: str) -> None:
    """``python -m go_pocket_tts_tpu_torch synth`` as a subprocess on the card."""
    out = os.path.join(root, "build", "phase11.wav")
    if os.path.exists(out):
        os.remove(out)
    env = {
        **os.environ,
        "PYTHONPATH": root,
        "POCKETTTS_PATHS_MODEL_PATH": model_path,
        "POCKETTTS_PATHS_TOKENIZER_MODEL": tok_path,
        "POCKETTTS_RUNTIME_DTYPE": "bfloat16",
        "POCKETTTS_RUNTIME_SEED": str(SEED),
        "POCKETTTS_EOS_THRESHOLD": "1e9",
    }
    env.pop("POCKETTTS_PLATFORM", None)
    text = STREAM_TEXTS[0]
    cmd = [sys.executable, "-m", "go_pocket_tts_tpu_torch", "synth", "--text", text, "--out", out]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        fail(f"CLI synth exited {proc.returncode}: {proc.stderr[-2000:]}")
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer

    (_ids, frames), = chunk_frames(load_tokenizer(tok_path), text)
    with open(out, "rb") as f:
        check_wav(f.read(), frames, "CLI synth")
    print(
        f"  CLI synth subprocess: {frames} frames to {os.path.relpath(out, root)} in {wall:.1f} s wall "
        f"(interpreter start, model load, kernel libraries from _build/)  [{CARD}]"
    )


def entry_points(model, root: str):
    """Phase 11; returns the fixtures' paths. Its launches are read into a
    dict of their own: the kernel table's totals stay those of phases 3, 5,
    7 and 9."""
    from go_pocket_tts_tpu_torch import kernels

    t = time.perf_counter()
    model_path, tok_path = entry_fixtures(root)
    print(f"  fixtures written in {time.perf_counter() - t:.1f} s  [{CARD}]")
    counts: dict = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    single_service(model, model_path, tok_path)
    serve_batcher(model_path, tok_path)
    read_launches(
        "the entry points (Service, HTTP server)",
        (
            "decode_attention_step",
            "fused_seanet_up_tail",
            "batched_decode_attention_int8",
            "quantized_matmul",
            "fused_up2_res",
            "fused_up2_up3_tail",
        ),
        counts,
        shapes=None,
    )
    cli_synth(root, model_path, tok_path)
    return model_path, tok_path


# -- phase 12: batched serving, whole -------------------------------------------

# The SEANet kernels' launches by input shape in phase 12 (re-timed apart
# from the kernel table's paths, PATH_SHAPES).
PHASE12_SHAPES: dict = {}
# The batcher's serving settings (``config.apply_serving_autotune``), as in
# phases 5 and 11, at the default 256 frames.
SERVING = dict(slots=8, prompt_capacity=128, steps_per_sync=8, steps_per_sync_burst=64, quantize=True, kv_quantize=True)


class BlockLog:
    """The size of every AR block the batcher enqueues while it is open,
    with whether a streaming lane was attached then (the module's
    ``_batched_ar_multi_step`` wrapped; the engine looks it up per block)."""

    def __init__(self, batcher) -> None:
        from go_pocket_tts_tpu_torch.parallel import batching

        self.blocks: list = []
        self._mod, self._orig = batching, batching._batched_ar_multi_step

        def logged(params, cfg, state, k, *args):
            self.blocks.append((k, batcher._any_streaming()))
            return self._orig(params, cfg, state, k, *args)

        batching._batched_ar_multi_step = logged

    def __enter__(self) -> "BlockLog":
        return self

    def __exit__(self, *exc) -> None:
        self._mod._batched_ar_multi_step = self._orig

    def runs(self) -> list:
        """``[[k, streaming, n_blocks], ...]`` in order."""
        out: list = []
        for k, streaming in self.blocks:
            if out and out[-1][:2] == [k, streaming]:
                out[-1][2] += 1
            else:
                out.append([k, streaming, 1])
        return out


def _consume(blocks, t0: float, out: dict) -> None:
    """Drain a stream, noting when its first block arrived (seconds since
    ``t0``); an exception is kept for the caller to raise."""
    try:
        parts = []
        for block in blocks:
            if not parts:
                out["first"] = time.perf_counter() - t0
            parts.append(block)
        out["blocks"] = parts
    except Exception as exc:  # noqa: BLE001
        out["error"] = exc


def _streams(gens, t0: float) -> list:
    """Drain the streams ``gens`` at once, each on a thread of its own."""
    import threading

    outs = [{} for _ in gens]
    threads = [threading.Thread(target=_consume, args=(g, t0, o)) for g, o in zip(gens, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for i, out in enumerate(outs):
        if "error" in out:
            fail(f"stream {i}: {out['error']!r}")
        if "blocks" not in out:
            fail(f"stream {i} did not end")
    return outs


def mixed_wave(rt, arch, counts: dict) -> dict:
    """Phase 5's 16 requests at once, the first 8 streamed: each streamed
    lane's time to its first block, the aggregate x real time, and the
    block sizes (8 while a lane streams, 64 after); returns the first
    three (seconds) as ``first_s``, ``wall_s`` and ``audio_s``."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames

    batcher = rt.batcher
    requests, cfg = serving_requests(arch)
    torch.cuda.synchronize()
    with BlockLog(batcher) as log:
        kernels.reset_launches()
        t0 = time.perf_counter()
        gens = [batcher.submit_stream(tokens, cfg, timeout=300) for tokens in requests[:8]]
        futs = [batcher.submit(tokens, cfg) for tokens in requests[8:]]
        outs = _streams(gens, t0)
        plain = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    must = ("fused_up2_up3_tail", "batched_decode_attention_int8", "quantized_matmul", "fused_up2_res", "fused_seanet_up_tail")
    read_launches("phase 12's mixed wave", must, counts, PHASE12_SHAPES)
    secs = 0.0
    for i, (tokens, out) in enumerate(zip(requests[:8], outs)):
        frames = estimate_max_frames(len(tokens))
        sizes = [len(b) // 1920 for b in out["blocks"]]
        if any(n != 8 for n in sizes[:-1]) or not 0 < sizes[-1] <= 8:
            fail(f"streamed lane {i}: blocks of {sizes} frames, want 8s then one of 1-8")
        check_audio(np.concatenate(out["blocks"]), frames, f"streamed lane {i}")
        secs += frames * 1920 / 24000
    for i, (tokens, audio) in enumerate(zip(requests[8:], plain)):
        check_audio(audio, estimate_max_frames(len(tokens)), f"plain lane {i}")
        secs += len(audio) / 24000
    firsts = sorted(out["first"] for out in outs)
    runs = log.runs()
    if any((k == 8) != streaming for k, streaming, _ in runs):
        fail(f"block sizes {runs}: want 8 exactly while a lane streams, 64 otherwise")
    print(
        f"  mixed wave, 8 streamed + 8 plain requests of {min(map(len, requests))}-{max(map(len, requests))} "
        f"tokens: time to first block p50 {statistics.median(firsts) * 1e3:.1f} ms, max {firsts[-1] * 1e3:.1f} ms "
        f"(all {[round(f * 1e3, 1) for f in firsts]}); {secs:.2f} s of audio in {wall * 1e3:.1f} ms wall: "
        f"x{secs / wall:.2f} real time aggregate  [{CARD}]"
    )
    print(f"  block sizes the engine ran, [k, a lane streaming, blocks] in order: {runs}")
    return {"first_s": firsts, "wall_s": wall, "audio_s": secs}


def voices_sessions_cancel(rt, arch, counts: dict) -> None:
    """One burst with an embedding voice, a model-state voice and two plain
    requests (temperature 0); a three-chunk ``generate_session`` and a
    three-chunk ``stream_session`` next to plain load; a stream closed after
    its first block."""
    import threading

    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig

    batcher = rt.batcher
    requests = main_requests(arch)
    tokens, other = requests[1][0], requests[0][0]
    voice = (np.random.RandomState(SEED + 9).randn(1, 32, arch.d_model) * 0.02).astype(np.float32)
    cfg0 = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=64)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    futs = [
        batcher.submit(tokens, dataclasses.replace(cfg0, voice_embedding=voice)),
        batcher.submit(tokens, dataclasses.replace(cfg0, voice_model_state=synthetic_voice_state(arch, 48, 40))),
        batcher.submit(tokens, cfg0),
        batcher.submit(other, cfg0),
    ]
    emb, state, plain, _other = (f.result(timeout=300) for f in futs)
    wall = time.perf_counter() - t
    for audio, what in ((emb, "embedding-voiced"), (state, "model-state-voiced"), (plain, "plain"), (_other, "other")):
        check_audio(audio, 64, f"voice burst, {what} request")
    d_emb, d_state = (float(np.sqrt(np.mean((a - plain) ** 2))) for a in (emb, state))
    print(
        f"  voice burst (embedding [1, 32, 1024], model state 48 frames at offset 40, 2 plain; 64 frames each) "
        f"in {wall * 1e3:.1f} ms; RMS voiced - plain, same tokens: embedding {d_emb:.3e}, model state "
        f"{d_state:.3e}  [{CARD}]"
    )
    if not (d_emb > 1e-3 and d_state > 1e-3):
        fail("a voiced request's PCM did not differ from the plain request's")

    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=48)
    chunks = [tok for tok, _ in requests]
    report: dict = {"plain": [], "streamed": []}

    def plain_session():
        cont = None
        for tok in chunks:
            t = time.perf_counter()
            audio, cont = batcher.generate_session(tok, cfg, cont, timeout=300)
            report["plain"].append((len(audio) // 1920, time.perf_counter() - t, int(cont.offset[0])))

    def streamed_session():
        cont = None
        for tok in chunks:
            t = time.perf_counter()
            blocks, next_state = batcher.stream_session(tok, cfg, cont, timeout=300)
            blocks = list(blocks)
            cont = next_state()
            report["streamed"].append((sum(len(b) for b in blocks) // 1920, time.perf_counter() - t, int(cont.offset[0])))

    load = [batcher.submit(tok, cfg) for tok, _ in requests * 2]
    threads = [threading.Thread(target=fn) for fn in (plain_session, streamed_session)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    for f in load:
        check_audio(f.result(timeout=300), 48, "session load")
    for kind, rows in report.items():
        offsets = [r[2] for r in rows]
        if [r[0] for r in rows] != [48] * 3 or offsets != sorted(offsets):
            fail(f"{kind} session chunks {rows}: want 48 frames each, carried (offsets growing)")
        print(
            f"  {kind} session, 3 chunks of {[len(c) for c in chunks]} tokens x 48 frames next to 6 plain "
            f"requests: walls {[round(r[1] * 1e3, 1) for r in rows]} ms, carried offsets {offsets}  [{CARD}]"
        )

    with BlockLog(batcher) as log:
        blocks = batcher.submit_stream(tokens, dataclasses.replace(cfg, max_steps=200), timeout=300)
        next(blocks)
        n0 = len(log.blocks)
        blocks.close()
        deadline = time.perf_counter() + 30
        while any(s.request is not None for s in batcher._slot_info) and time.perf_counter() < deadline:
            time.sleep(0.001)
        freed_after = len(log.blocks) - n0
    if freed_after > 2 or any(s.request is not None for s in batcher._slot_info):
        fail(f"cancelled stream: lane not free within two blocks ({freed_after} blocks after the close)")
    check_audio(batcher.generate(other, dataclasses.replace(cfg0, max_steps=16), timeout=300), 16, "after the cancel")
    print(f"  stream closed after its first block: lane free {freed_after} block(s) after the close; the next request completed")
    must = ("fused_up2_up3_tail", "batched_decode_attention_int8", "quantized_matmul", "fused_up2_res", "fused_seanet_up_tail")
    read_launches("phase 12's voices, sessions and cancel", must, counts, PHASE12_SHAPES)


def _http_stream_chunks(port: int, text: str, t0: float, voice: str = "") -> list:
    """POST /tts/stream (with ``voice``, if given) and read its chunked body
    off the socket: ``[(seconds since t0, payload), ...]``, the WAV header
    first."""
    import socket

    body = json.dumps({"text": text, **({"voice": voice} if voice else {})}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=300) as sock:
        sock.sendall(
            b"POST /tts/stream HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
            + body
        )
        f = sock.makefile("rb")
        status = f.readline()
        if b" 200 " not in status:
            fail(f"POST /tts/stream: {status!r}")
        while f.readline() not in (b"\r\n", b""):
            pass
        chunks = []
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                return chunks
            chunks.append((time.perf_counter() - t0, f.read(n)))
            f.readline()


def serve_batcher_streams(model_path: str, tok_path: str, counts: dict) -> None:
    """The batcher server of phase 11 (8 slots, serving autotune) with a
    voice manifest: 8 POST /tts/stream at once, then one POST /tts with the
    manifest's voice."""
    from concurrent.futures import ThreadPoolExecutor

    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.config import apply_serving_autotune
    from go_pocket_tts_tpu_torch.server import Server
    from go_pocket_tts_tpu_torch.tts.service import Service
    from go_pocket_tts_tpu_torch.tts.voices import VoiceManager
    from go_pocket_tts_tpu_torch.utils.safetensors import write_file
    from go_pocket_tts_tpu_torch.utils.wav import streaming_wav_header

    arch, _ = checkpoint()
    vdir = os.path.join(os.path.dirname(model_path), "voices")
    os.makedirs(vdir, exist_ok=True)
    voice = (np.random.RandomState(SEED + 9).randn(32, arch.d_model) * 0.02).astype(np.float32)
    write_file(os.path.join(vdir, "synthetic.safetensors"), {"audio_prompt": voice})
    with open(os.path.join(vdir, "manifest.json"), "w") as f:
        json.dump({"voices": [{"id": "synthetic", "path": "synthetic.safetensors", "license": "seeded"}]}, f)
    cfg = entry_config(model_path, tok_path, batch_slots=8, temperature=0.7)
    apply_serving_autotune(cfg)
    svc = Service.from_config(cfg)
    srv = Server(svc, VoiceManager(os.path.join(vdir, "manifest.json")), listen_addr="127.0.0.1:0", workers=8,
                 request_timeout=300)
    srv.start()
    try:
        frames = [chunk_frames(svc.tokenizer, text)[0][1] for text in BATCH_TEXTS]
        _http_stream_chunks(srv.port, BATCH_TEXTS[0], time.perf_counter())  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ThreadPoolExecutor(max_workers=len(BATCH_TEXTS)) as pool:
            t0 = time.perf_counter()
            replies = list(pool.map(lambda text: _http_stream_chunks(srv.port, text, t0), BATCH_TEXTS))
            wall = time.perf_counter() - t0
        firsts = []
        for i, (reply, n) in enumerate(zip(replies, frames)):
            if reply[0][1] != streaming_wav_header():
                fail(f"batcher POST /tts/stream {i}: not the streaming WAV header")
            pcm = reply[1:]
            if len(pcm) < 2 or sum(len(p) for _, p in pcm) != n * 1920 * 2:
                fail(f"batcher POST /tts/stream {i}: {len(pcm)} PCM chunks, {sum(len(p) for _, p in pcm)} bytes")
            firsts.append(pcm[0][0])
        print(
            f"  batcher server, 8 POST /tts/stream at once ({frames} frames; one text chunk each, "
            f"{[len(r) - 1 for r in replies]} PCM blocks): first PCM byte {[round(f * 1e3, 1) for f in firsts]} ms "
            f"(p50 {statistics.median(firsts) * 1e3:.1f}, max {max(firsts) * 1e3:.1f}); {sum(frames) * 1920 / 24000:.2f} s "
            f"of audio in {wall * 1e3:.1f} ms wall: x{sum(frames) * 1920 / 24000 / wall:.2f} real time aggregate  [{CARD}]"
        )
        t = time.perf_counter()
        req_body = json.dumps({"text": BATCH_TEXTS[2], "voice": "synthetic"}).encode()
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/tts", data=req_body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body = resp.status, resp.read()
        if status != 200:
            fail(f"voiced POST /tts: status {status}")
        check_wav(body, frames[2], "voiced POST /tts")
        print(f"  batcher server, POST /tts with the manifest's voice: 200, valid WAV in {(time.perf_counter() - t) * 1e3:.1f} ms  [{CARD}]")
    finally:
        srv.shutdown()
        svc.close()
    must = ("fused_up2_up3_tail", "batched_decode_attention_int8", "quantized_matmul", "fused_up2_res", "fused_seanet_up_tail")
    read_launches("phase 12 over HTTP", must, counts, PHASE12_SHAPES)


# The float batcher's streamed wave, kernels against plain: only the float
# kernels' summation order differs (4 and 8), so the PCM, int16 on the
# device, differs by a few samples flipped one step (phase 10's streamed
# PCM truncated to int16 reads 8.2e-7).
F32_FLOAT_STREAM_TOL = 1e-5


def f32_batched_streaming(arch, int8_one_shot: float) -> None:
    """float32, temperature 0, at the serving settings: the streamed lanes
    against the same batcher's one-shot generate (both int16), the streamed
    wave with the kernels against their plain versions on the int8 batcher
    (beside its one-shot wave's kernels against plain and phase 6's
    ``int8_one_shot``, lane by lane) and on a float-weight float-KV batcher
    (within ``F32_FLOAT_STREAM_TOL``), and a batched session's second chunk
    against ``GPURuntime.generate_audio_session``'s. The launches of each
    kernel run are read, and must include the kernels it runs."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
    from go_pocket_tts_tpu_torch.runtime import GPURuntime

    arch, model32 = build_model(torch.float32)
    tokens, other, cfg = parity_requests(arch)
    reqs = [tokens, other] + [tok for tok, _ in main_requests(arch)[:2]]
    seen: dict = {}  # these checks' launches stay out of phase 12's counts
    int8_must = ("batched_decode_attention_int8", "quantized_matmul")

    def batcher(**kw):
        b = ContinuousBatcher(model32, dtype=torch.float32, seed=SEED, device="cuda", **{**SERVING, **kw})
        b.start()
        return b

    def run(b, streamed: bool, what: str, must=()):
        kernels.reset_launches()
        if streamed:
            outs = _streams([b.submit_stream(t, cfg, timeout=300) for t in reqs], time.perf_counter())
            lanes = [np.concatenate(o["blocks"]) for o in outs]
        else:
            lanes = [f.result(timeout=300) for f in [b.submit(t, cfg) for t in reqs]]
        read_launches(f"the f32 {what}", must, seen, None)
        for lane in lanes:
            check_audio(lane, 40, f"f32 {what}")
        return lanes

    def by_lane(a, b):
        return [float(np.sqrt(np.mean((x.astype(np.float64) - y) ** 2))) for x, y in zip(a, b)]

    b = batcher()
    try:
        stream_k = run(b, True, "int8 batcher's streamed wave", ("fused_up2_up3_tail", *int8_must))
        one_k = run(b, False, "int8 batcher's one-shot wave", ("fused_up2_res", "fused_seanet_up_tail", *int8_must))
    finally:
        b.stop()
    rms_check(np.concatenate(stream_k), np.concatenate(one_k),
              "f32 real_arch, 4 lanes x 40 frames, int8 batcher, streamed - one-shot (int16)")
    undo = plain_versions()
    try:
        b = batcher()
        try:
            stream_p = run(b, True, "int8 batcher's streamed wave, plain versions")
            one_p = run(b, False, "int8 batcher's one-shot wave, plain versions")
        finally:
            b.stop()
        b = batcher(quantize=False, kv_quantize=False)
        try:
            float_p = run(b, True, "float batcher's streamed wave, plain versions")
        finally:
            b.stop()
    finally:
        undo()
    rms_check(np.concatenate(stream_k), np.concatenate(stream_p),
              "f32 real_arch, 4 lanes x 40 frames, int8 batcher streamed, kernels - plain")
    rms_check(np.concatenate(one_k), np.concatenate(one_p),
                         "f32 real_arch, 4 lanes x 40 frames, int8 batcher one-shot, kernels - plain")
    print(
        f"  the same by lane: streamed {[f'{r:.3e}' for r in by_lane(stream_k, stream_p)]}, one-shot "
        f"{[f'{r:.3e}' for r in by_lane(one_k, one_p)]}; phase 6 (lanes 1-2 only, default blocks, one-shot) "
        f"{int8_one_shot:.3e}; plain streamed - plain one-shot "
        f"{float(np.sqrt(np.mean((np.concatenate(stream_p).astype(np.float64) - np.concatenate(one_p)) ** 2))):.3e}"
        f"  [{CARD}]"
    )
    b = batcher(quantize=False, kv_quantize=False)
    try:
        float_k = run(b, True, "float batcher's streamed wave", ("fused_up2_up3_tail", "batched_decode_attention"))
        _a, cont = b.generate_session(tokens, cfg, None, timeout=300)
        got, _ = b.generate_session(other, cfg, cont, timeout=300)
    finally:
        b.stop()
    rms_check(np.concatenate(float_k), np.concatenate(float_p),
              "f32 real_arch, 4 lanes x 40 frames, float batcher streamed, kernels - plain", F32_FLOAT_STREAM_TOL)
    print(f"  the same by lane: {[f'{r:.3e}' for r in by_lane(float_k, float_p)]}  [{CARD}]")
    rt = GPURuntime(model32, dtype=torch.float32, seed=SEED, device="cuda")
    _a, rcont = rt.generate_audio_session(tokens, cfg, None)
    want, _ = rt.generate_audio_session(other, cfg, rcont)
    check_audio(got, 40, "f32 batched session, chunk 2")
    rms_check(got, want, "f32 real_arch, session chunk 2 (40 frames), batcher - GPURuntime.generate_audio_session")


def batched_serving_whole(model, arch, fixtures, int8_one_shot: float) -> None:
    """Phase 12. Its launches are read into a dict of their own, and its
    SEANet shapes into PHASE12_SHAPES: the kernel table's totals stay those
    of phases 3, 5, 7 and 9."""
    from go_pocket_tts_tpu_torch.parallel import BatcherRuntime

    counts: dict = {}
    rt = BatcherRuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda", **SERVING)
    try:
        t = time.perf_counter()
        rt.prewarm((12,))
        print(f"  BatcherRuntime.prewarm((12,)) in {(time.perf_counter() - t) * 1e3:.1f} ms  [{CARD}]")
        mixed_wave(rt, arch, counts)
        voices_sessions_cancel(rt, arch, counts)
    finally:
        rt.close()
    del rt
    torch.cuda.empty_cache()
    serve_batcher_streams(*fixtures, counts)
    f32_batched_streaming(arch, int8_one_shot)
    torch.cuda.empty_cache()
    print(f"  phase 12 launches: {counts}")


# -- phase 13: voice cloning ------------------------------------------------------

CLIP_SECONDS = 10.0
LONG_CLIP_SECONDS = 45.0  # past the encoder's 40.96 s: refused with 400
ENCODE_RTOL = 1e-4  # relative RMS of an encode against the CPU's, float32
ENCODE_BUCKETS = (64, 128, 256, 512)  # the upload buckets, in frames


def speaker_clip(seconds: float, seed: int) -> np.ndarray:
    """A seeded voice-like clip at 24 kHz: a gliding fundamental and two
    harmonics, syllable-rate amplitude, and noise; float32 in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 24000)) / 24000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.4 * t) + 5 * rng.randn()
    phase = 2 * np.pi * np.cumsum(f0) / 24000
    x = 0.3 * np.sin(phase) + 0.15 * np.sin(2 * phase + 0.3) + 0.08 * np.sin(3 * phase + 1.1)
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.randn(t.size)
    return np.clip(x, -1, 1).astype(np.float32)


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2)))


def encode_work(encoder, n: int):
    """(bytes, operations) of one encode of ``n`` samples and its speaker
    projection: the PCM, every weight and the conditioning once; each
    convolution at its output length, the transformer's linears, its
    windowed attention over the causal pairs its window holds (QK and PV),
    the downsample and the projection; a multiply-add is two operations."""
    from go_pocket_tts_tpu_torch.models.params import tree_map

    params, cfg = encoder.encoder, encoder.cfg

    def conv(p, t_out: int) -> float:
        o, i, k = p["w"].shape
        return 2.0 * o * i * k * t_out

    t = n
    flops = conv(params["init_conv"], t)
    for slot, stride in enumerate(reversed(cfg.seanet_strides)):
        res = params[f"res{slot + 1}"]
        flops += conv(res["conv1"], t) + conv(res["conv2"], t)
        t //= stride
        flops += conv(params[f"down{slot + 1}"], t)
    flops += conv(params["final_conv"], t)
    d = params["final_conv"]["w"].shape[0]
    pairs = float(np.minimum(np.arange(1, t + 1), cfg.context).sum())
    for layer in params["transformer"]["layers"]:
        flops += 2.0 * t * sum(layer[k]["w"].numel() for k in ("in_proj", "out_proj", "linear1", "linear2"))
        flops += 2 * 2.0 * pairs * d
    frames = t // cfg.steps_per_latent
    flops += conv(params["downsample"], frames) + 2.0 * frames * encoder.speaker_proj.numel()
    sizes: list = []
    tree_map(lambda _path, leaf: sizes.append(leaf.numel() * leaf.element_size()), params)
    weights = sum(sizes) + encoder.speaker_proj.numel() * 4
    return 4.0 * n + weights + 4.0 * frames * encoder.speaker_proj.shape[0], flops


def encoder_on_card(tensors, clip: np.ndarray) -> None:
    """The float32 encoder on the card against the same function on the CPU
    (the card's run with TF32 switched on in this process: the encoder
    scopes float32 itself), padded against unpadded on the card, and the
    encode's device time at each upload bucket beside its bound."""
    from go_pocket_tts_tpu_torch.device import exact_float32
    from go_pocket_tts_tpu_torch.models.mimi_encoder import mimi_encode
    from go_pocket_tts_tpu_torch.tts.voice_export import VoiceEncoder

    t = time.perf_counter()
    card = VoiceEncoder(tensors, device="cuda")
    cpu = VoiceEncoder(tensors, device="cpu")
    print(f"  VoiceEncoder built on the card and on the CPU in {time.perf_counter() - t:.1f} s  [{CARD}]")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = card.encode_samples(clip, 24000)
        padded = card.encode_samples(clip, 24000, pad_to_bucket=True)
        if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != (True, True):
            fail("the encode did not restore the caller's TF32 flags")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    t = time.perf_counter()
    want = cpu.encode_samples(clip, 24000)
    cpu_s = time.perf_counter() - t
    frames = len(clip) // 1920
    want_shape = (1, frames, card.speaker_proj.shape[0])
    if got.shape != want_shape or not np.isfinite(got).all():
        fail(f"encoder on the card: {got.shape}, want {want_shape}, finite")
    err = rel_rms(got, want)
    pad_err = float(np.abs(padded - got).max())
    print(
        f"  encoder float32, {CLIP_SECONDS:.0f} s clip -> {got.shape}: card (TF32 on in the process) against CPU: "
        f"RMS {np.sqrt(np.mean(want ** 2)):.4e}, max abs {np.abs(got - want).max():.3e}, relative RMS {err:.3e} "
        f"(budget {ENCODE_RTOL}); padded to {next(b for b in ENCODE_BUCKETS if b >= frames)} frames (local attention) against unpadded (dense), "
        f"card: max abs {pad_err:.3e}; the CPU encode took {cpu_s:.2f} s  [{CARD}]"
    )
    if err > ENCODE_RTOL or pad_err > 1e-5:
        fail(f"encoder: card against CPU relative RMS {err:.3e}, padded against unpadded {pad_err:.3e}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for frames in ENCODE_BUCKETS:
        n = frames * 1920
        pcm = torch.randn((1, 1, n), generator=gen, device="cuda") * 0.1

        def encode():
            emb = mimi_encode(card.encoder, card.cfg, pcm)
            return torch.matmul(emb.transpose(1, 2), card.speaker_proj.T)

        with torch.inference_mode(), exact_float32():
            encode()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = eager_ms(encode, 5)
            peak = torch.cuda.max_memory_allocated()
        bytes_moved, flops = encode_work(card, n)
        b_ms, by = bound(bytes_moved, flops, torch.float32)
        print(
            f"  encode, {frames} frames ({n / 24000:.2f} s, {n // 120} steps at 200 Hz): {ms:.3f} ms (median of 5, "
            f"CUDA events) against a bound of {b_ms:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP float32 at "
            f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s), x{ms / b_ms:.1f}; {flops / ms / 1e9:.1f} TFLOP/s; "
            f"peak memory {peak / 2**20:.0f} MiB ({(peak - base) / 2**20:.0f} MiB above the "
            f"{base / 2**20:.0f} MiB held before)  [{CARD}]"
        )


def exported_voices(model, arch, root: str, model_path: str, clip_path: str, counts: dict):
    """Both voice kinds exported from the clip on the card, their kinds
    checked, then 24 tokens synthesized with each through ``GPURuntime``
    (bfloat16, temperature 0) beside the plain request; returns the
    exported embedding and model state."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
    from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames
    from go_pocket_tts_tpu_torch.tts.voice_export import export_voice_embedding, export_voice_model_state
    from go_pocket_tts_tpu_torch.utils.safetensors import (
        VoiceFileKind,
        inspect_voice_file,
        load_voice_embedding,
        load_voice_model_state,
    )

    out = os.path.join(root, "build", "phase13")
    emb_path, state_path = os.path.join(out, "voice_embedding.safetensors"), os.path.join(out, "voice_state.safetensors")
    t = time.perf_counter()
    emb = export_voice_embedding(model_path, clip_path, emb_path, device="cuda")
    t_emb = time.perf_counter() - t
    t = time.perf_counter()
    offset = export_voice_model_state(model_path, clip_path, state_path, num_heads=arch.num_heads, device="cuda")
    t_state = time.perf_counter() - t
    kinds = (inspect_voice_file(emb_path), inspect_voice_file(state_path))
    if kinds != (VoiceFileKind.EMBEDDING, VoiceFileKind.MODEL_STATE) or offset != emb.shape[1]:
        fail(f"exported voices: kinds {kinds}, offset {offset} for {emb.shape[1]} frames")
    state = load_voice_model_state(state_path)
    print(
        f"  export-voice in process: embedding {emb.shape} in {t_emb:.1f} s, model state ({len(state.modules)} layers, "
        f"offset {offset}) in {t_state:.1f} s (each: checkpoint read, encoder load, encode; the state also the "
        f"float32 model and its prefill)  [{CARD}]"
    )

    rt = GPURuntime(model, dtype=torch.bfloat16, seed=SEED, device="cuda")
    tokens = main_requests(arch)[1][0]
    frames = estimate_max_frames(len(tokens))
    cfg0 = GenerateConfig(temperature=0.0, eos_threshold=1e9)
    rt.generate_audio(tokens, dataclasses.replace(cfg0, voice_embedding=load_voice_embedding(emb_path)))  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    walls = {}
    audio = {}
    for what, cfg in (
        ("plain", cfg0),
        ("embedding", dataclasses.replace(cfg0, voice_embedding=load_voice_embedding(emb_path))),
        ("model state", dataclasses.replace(cfg0, voice_model_state=state)),
    ):
        t = time.perf_counter()
        audio[what] = rt.generate_audio(tokens, cfg)
        walls[what] = time.perf_counter() - t
        check_audio(audio[what], frames, f"GPURuntime, {what}")
    read_launches(
        "phase 13's voiced GPURuntime requests",
        ("decode_attention_step", "fused_up2_res", "fused_seanet_up_tail"),
        counts,
        shapes=None,
    )
    d_emb, d_state = (float(np.sqrt(np.mean((audio[w] - audio["plain"]) ** 2))) for w in ("embedding", "model state"))
    print(
        f"  GPURuntime bf16, {len(tokens)} tokens, {frames} frames, temperature 0: walls "
        f"{ {k: round(v * 1e3, 1) for k, v in walls.items()} } ms; RMS voiced - plain: exported embedding "
        f"{d_emb:.3e}, exported model state {d_state:.3e}  [{CARD}]"
    )
    if not (d_emb > 1e-3 and d_state > 1e-3):
        fail("a request voiced by an exported voice did not differ from the plain request")
    return emb, state


def _post_json(port: int, path: str, obj, timeout: float = 300.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(obj), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _tts_wave(port: int, frames, upload=None):
    """8 POST /tts at once (BATCH_TEXTS), each WAV checked; with ``upload``
    (an id and a WAV) one POST /voices sent beside them. Returns the wave's
    wall, its PCM and the upload's (status, wall)."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    from go_pocket_tts_tpu_torch.utils.wav import decode_wav

    def tts(text):
        status, body = _post_json(port, "/tts", {"text": text})
        if status != 200:
            fail(f"POST /tts in a wave: status {status}: {body[:200]!r}")
        return body

    def up():
        t = time.perf_counter()
        status, body = _post_json(port, "/voices", {"id": upload[0], "audio": base64.b64encode(upload[1]).decode()})
        return status, time.perf_counter() - t, body

    with ThreadPoolExecutor(max_workers=len(BATCH_TEXTS) + 1) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(tts, text) for text in BATCH_TEXTS]
        uploaded = pool.submit(up) if upload else None
        bodies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        up_result = uploaded.result() if uploaded else None
    for i, (body, n) in enumerate(zip(bodies, frames)):
        check_wav(body, n, f"wave POST /tts {i}")
    return wall, [decode_wav(b)[0] for b in bodies], up_result


def upload_server(model_path: str, tok_path: str, clip_wav: bytes, long_wav: bytes, counts: dict) -> None:
    """The port's server over the 8-slot int8 batcher service (serving
    autotune, temperature 0) with a ``VoiceUploader`` over a temporary
    directory: uploads with and without prewarm, ``GET /voices``, a voiced
    ``POST /tts`` and ``POST /tts/stream``, 409 and 400, and a wave of 8
    ``POST /tts`` with and without an upload beside it."""
    import base64
    import urllib.request

    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.config import apply_serving_autotune
    from go_pocket_tts_tpu_torch.server import Server
    from go_pocket_tts_tpu_torch.tts.service import Service
    from go_pocket_tts_tpu_torch.tts.voice_upload import VoiceUploader
    from go_pocket_tts_tpu_torch.tts.voices import VoiceManager
    from go_pocket_tts_tpu_torch.utils.wav import decode_wav, streaming_wav_header

    cfg = entry_config(model_path, tok_path, batch_slots=8, temperature=0.0)
    apply_serving_autotune(cfg)
    # A 10 s voice takes 125 prompt positions: with a text chunk the prompt
    # buckets to 256, past the default KV room of 128.
    cfg.runtime.batch_prompt_capacity = 256
    svc = Service.from_config(cfg)
    with tempfile.TemporaryDirectory() as vdir:
        voices = VoiceManager.in_memory(vdir)
        uploader = VoiceUploader(model_path, vdir, voices, service=svc, prewarm=True, device="cuda")
        srv = Server(svc, voices, listen_addr="127.0.0.1:0", workers=8, request_timeout=300, voice_uploader=uploader)
        srv.start()
        try:
            port = srv.port
            audio = base64.b64encode(clip_wav).decode()
            frames = [chunk_frames(svc.tokenizer, text)[0][1] for text in BATCH_TEXTS]
            _post_json(port, "/tts", {"text": BATCH_TEXTS[0]})  # warm-up
            walls = []
            # The first upload builds the encoder (checkpoint read); the
            # next two encode with it, with and without the prewarm.
            for vid, prewarm in (("first", False), ("cloned", True), ("cloned-cold", False)):
                uploader.prewarm = prewarm
                t = time.perf_counter()
                status, body = _post_json(port, "/voices", {"id": vid, "audio": audio})
                walls.append(time.perf_counter() - t)
                record = json.loads(body).get("voice", {}) if status == 200 else {}
                if status != 200 or record.get("frames") != int(CLIP_SECONDS * 12.5) or record.get("prewarmed") != prewarm:
                    fail(f"POST /voices {vid}: {status} {body[:300]!r}")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/voices", timeout=60) as resp:
                listed = [v["id"] for v in json.loads(resp.read())["voices"]]
            if listed != ["first", "cloned", "cloned-cold"]:
                fail(f"GET /voices after the uploads: {listed}")
            print(
                f"  POST /voices, {CLIP_SECONDS:.0f} s clip ({len(clip_wav)} WAV bytes): the first (encoder build, "
                f"no prewarm) {walls[0] * 1e3:.1f} ms, then with prewarm {walls[1] * 1e3:.1f} ms, without prewarm "
                f"{walls[2] * 1e3:.1f} ms; GET /voices lists {listed}  [{CARD}]"
            )

            torch.cuda.synchronize()
            kernels.reset_launches()
            t = time.perf_counter()
            status, body = _post_json(port, "/tts", {"text": BATCH_TEXTS[2], "voice": "cloned"})
            t_tts = time.perf_counter() - t
            if status != 200:
                fail(f"voiced POST /tts: {status} {body[:200]!r}")
            check_wav(body, frames[2], "POST /tts with the uploaded voice")
            plain_status, plain = _post_json(port, "/tts", {"text": BATCH_TEXTS[2]})
            d_voice = float(np.sqrt(np.mean((decode_wav(body)[0] - decode_wav(plain)[0]) ** 2)))
            t = time.perf_counter()
            reply = _http_stream_chunks(port, BATCH_TEXTS[3], t, voice="cloned")
            t_stream = time.perf_counter() - t
            if reply[0][1] != streaming_wav_header() or sum(len(p) for _, p in reply[1:]) != frames[3] * 1920 * 2:
                fail("POST /tts/stream with the uploaded voice: wrong header or length")
            read_launches(
                "phase 13's voiced requests over the upload server",
                ("batched_decode_attention_int8", "quantized_matmul", "fused_up2_res", "fused_seanet_up_tail",
                 "fused_up2_up3_tail"),
                counts,
                shapes=None,
            )
            print(
                f"  with the uploaded voice: POST /tts {frames[2]} frames in {t_tts * 1e3:.1f} ms (RMS voiced - "
                f"plain {d_voice:.3e}), POST /tts/stream {frames[3]} frames in {len(reply) - 1} PCM blocks, "
                f"first after {reply[1][0] * 1e3:.1f} ms, whole {t_stream * 1e3:.1f} ms  [{CARD}]"
            )
            if plain_status != 200 or not d_voice > 1e-3:
                fail(f"voiced POST /tts did not differ from the plain one (RMS {d_voice:.3e})")

            status, body = _post_json(port, "/voices", {"id": "cloned", "audio": audio})
            if status != 409:
                fail(f"duplicate POST /voices: {status}, want 409")
            status, long_body = _post_json(port, "/voices", {"id": "too-long", "audio": base64.b64encode(long_wav).decode()})
            if status != 400 or b"40.96 s" not in long_body:
                fail(f"{LONG_CLIP_SECONDS:.0f} s POST /voices: {status} {long_body[:300]!r}, want 400 naming 40.96 s")
            print(f"  duplicate id: 409; {LONG_CLIP_SECONDS:.0f} s clip: 400 {json.loads(long_body)['error']!r}")

            uploader.prewarm = False
            wall, base_pcm, _ = _tts_wave(port, frames)
            wall_up, up_pcm, (up_status, up_wall, up_body) = _tts_wave(port, frames, ("during-wave", clip_wav))
            if up_status != 200:
                fail(f"POST /voices beside the wave: {up_status} {up_body[:200]!r}")
            secs = sum(frames) * 1920 / 24000
            diff = max(float(np.abs(a - b).max()) for a, b in zip(base_pcm, up_pcm))
            print(
                f"  8 POST /tts at once ({frames} frames, temperature 0): x{secs / wall:.2f} real time aggregate "
                f"({wall * 1e3:.1f} ms) without an upload, x{secs / wall_up:.2f} ({wall_up * 1e3:.1f} ms) with one "
                f"POST /voices beside it (its wall {up_wall * 1e3:.1f} ms); max abs PCM difference between the two "
                f"waves {diff:.3e}  [{CARD}]"
            )
        finally:
            srv.shutdown()
            svc.close()


def cli_export_voice(root: str, model_path: str, clip_path: str, emb: np.ndarray, state) -> None:
    """``python -m go_pocket_tts_tpu_torch export-voice`` in both formats, as
    two subprocesses at once on the card with the process's default TF32
    flags, held against the in-process exports."""
    from go_pocket_tts_tpu_torch.utils.safetensors import load_voice_embedding, load_voice_model_state

    out = os.path.join(root, "build", "phase13")
    env = {**os.environ, "PYTHONPATH": root, "POCKETTTS_PATHS_MODEL_PATH": model_path}
    env.pop("POCKETTTS_PLATFORM", None)
    paths = {fmt: os.path.join(out, f"cli_{fmt}.safetensors") for fmt in ("embedding", "model-state")}
    t = time.perf_counter()
    procs = {
        fmt: subprocess.Popen(
            [sys.executable, "-m", "go_pocket_tts_tpu_torch", "export-voice", "--input", clip_path, "--output", path,
             "--format", fmt, "--voice-id", "cli"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for fmt, path in paths.items()
    }
    for fmt, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        lines = stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 2 or json.loads(lines[0])["frames"] != emb.shape[1]:
            fail(f"CLI export-voice --format {fmt} exited {proc.returncode}: {stdout[-500:]} {stderr[-2000:]}")
    wall = time.perf_counter() - t
    err_emb = rel_rms(load_voice_embedding(paths["embedding"]), emb)
    got = load_voice_model_state(paths["model-state"]).modules
    err_state = max(rel_rms(got[m]["cache"], state.modules[m]["cache"]) for m in state.modules)
    print(
        f"  CLI export-voice subprocesses (both formats at once, default TF32 flags) in {wall:.1f} s wall; against "
        f"the in-process exports: embedding relative RMS {err_emb:.3e}, model-state caches {err_state:.3e} "
        f"(budget {ENCODE_RTOL})  [{CARD}]"
    )
    if err_emb > ENCODE_RTOL or err_state > ENCODE_RTOL:
        fail(f"CLI export-voice against the in-process export: {err_emb:.3e}, {err_state:.3e}")


def voice_cloning(model, arch, fixtures, root: str) -> None:
    """Phase 13. Its launches are read into a dict of their own: the kernel
    table's totals stay those of phases 3, 5, 7 and 9."""
    from go_pocket_tts_tpu_torch.utils.wav import decode_wav, encode_wav

    model_path, tok_path = fixtures
    _, tensors = checkpoint()
    if "condition_provider.conditioners.speaker_wavs.output_proj.weight" not in tensors:
        fail("the seeded checkpoint has no speaker projection")
    out = os.path.join(root, "build", "phase13")
    os.makedirs(out, exist_ok=True)
    clip_wav = encode_wav(speaker_clip(CLIP_SECONDS, SEED + 13), 24000)
    long_wav = encode_wav(speaker_clip(LONG_CLIP_SECONDS, SEED + 14), 24000)
    clip_path = os.path.join(out, "speaker.wav")
    with open(clip_path, "wb") as f:
        f.write(clip_wav)
    clip = decode_wav(clip_wav)[0]  # the 16-bit samples the encoders read
    counts: dict = {}
    encoder_on_card(tensors, clip)
    emb, state = exported_voices(model, arch, root, model_path, clip_path, counts)
    torch.cuda.empty_cache()
    upload_server(model_path, tok_path, clip_wav, long_wav, counts)
    torch.cuda.empty_cache()
    cli_export_voice(root, model_path, clip_path, emb, state)
    print(f"  phase 13 launches: {counts}")


# -- phase 14: the CLI's tools: doctor, model assets, bench, stageprof -----------

# The bench and stageprof text (the CLI's default), one chunk for the
# fixture tokenizer.
TOOLS_TEXT = "The quick brown fox jumps over the lazy dog."
# One PCM16 step: generate_audio truncates toward zero, the staged PCM is float.
PCM16_STEP = 1.0 / 32767 + 1e-6


class _Env:
    """Set environment variables for a block (the in-process CLI reads its
    config from them), and restore the earlier values after it."""

    def __init__(self, **values: str) -> None:
        self.values = values
        self.saved: dict = {}

    def __enter__(self) -> "_Env":
        for key, value in self.values.items():
            self.saved[key] = os.environ.get(key)
            os.environ[key] = value
        return self

    def __exit__(self, *exc) -> None:
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def run_cli(args) -> tuple:
    """``cli.main.main(args)`` in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    from go_pocket_tts_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(list(args))
    return rc, out.getvalue(), err.getvalue()


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _doctor_start(root: str, model_path: str, tok_path: str):
    """``python -m go_pocket_tts_tpu_torch doctor`` as a subprocess on the card."""
    env = {**os.environ, "PYTHONPATH": root, "POCKETTTS_PATHS_MODEL_PATH": model_path,
           "POCKETTTS_PATHS_TOKENIZER_MODEL": tok_path}
    env.pop("POCKETTTS_PLATFORM", None)
    cmd = [sys.executable, "-m", "go_pocket_tts_tpu_torch", "doctor"]
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _doctor_check(proc, t0: float) -> None:
    from go_pocket_tts_tpu_torch.kernels import build

    out, err = proc.communicate(timeout=300)
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    for line in lines:
        print(f"    {line}")
    if proc.returncode != 0 or not lines or not all(line.startswith("✓") for line in lines):
        fail(f"doctor exited {proc.returncode} with a line not ✓: {out[-2000:]} {err[-2000:]}")
    backend = next((line for line in lines if line.startswith("✓ cuda backend")), "")
    kernel_line = next((line for line in lines if line.startswith("✓ cuda kernels")), "")
    if CARD not in backend or torch.cuda.get_device_name(0) not in backend:
        fail(f"doctor's cuda backend line does not name the card and its power limit ({CARD}): {backend}")
    libs = [build._target(name).name for name in build.SOURCES]
    if "sm_90a" not in kernel_line or not all(lib in kernel_line for lib in libs):
        fail(f"doctor's cuda kernels line does not name the sm_90a libraries {libs}: {kernel_line}")
    print(f"  doctor subprocess: {len(lines)} checks, all ✓, exit 0, {wall:.1f} s wall  [{CARD}]")


def exports(root: str, model_path: str, tok_path: str) -> dict:
    """``model export`` three ways through the CLI in process, each file's
    sha256 against the in-process exporter's on the same store, then
    ``model verify`` (smoke load on the card) and ``model dump-header`` of
    each; returns the paths by kind."""
    from go_pocket_tts_tpu_torch.cli.main import VOICE_CLONING_PREFIXES
    from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint, reencode_tensor
    from go_pocket_tts_tpu_torch.utils.safetensors import REQUIRED_MODEL_KEYS, encode_tensors, open_store

    import hashlib

    out = os.path.join(root, "build", "phase14")
    os.makedirs(out, exist_ok=True)
    store = open_store(model_path)
    kinds = {
        "strip": ["--strip-voice-cloning"],
        "int8": ["--quantize", "int8"],
        "int4": ["--quantize", "int4"],
    }
    paths = {}
    for kind, flags in kinds.items():
        path = os.path.join(out, f"{kind}.safetensors")
        t = time.perf_counter()
        with _Env(POCKETTTS_PATHS_MODEL_PATH=model_path):
            rc, stdout, stderr = run_cli(["model", "export", "--output", path, *flags])
        wall = time.perf_counter() - t
        if rc != 0:
            fail(f"model export {kind}: exit {rc}: {stderr[-2000:]}")
        if kind == "strip":
            keep = [n for n in store.names() if not n.startswith(VOICE_CLONING_PREFIXES)]
            tensors, meta = {n: reencode_tensor(store, n, "f32") for n in keep}, dict(store.metadata) or None
        else:
            tensors, meta, _ = build_quantized_checkpoint(store, 8 if kind == "int8" else 4, metadata=store.metadata)
        want = hashlib.sha256(encode_tensors(tensors, metadata=meta)).hexdigest()
        got = _sha256(path)
        if got != want:
            fail(f"model export {kind}: sha256 {got} != the in-process exporter's {want}")
        t = time.perf_counter()
        rc_v, verify_out, verify_err = run_cli(
            ["model", "verify", "--paths-model-path", path, "--paths-tokenizer-model", tok_path]
        )
        verify_wall = time.perf_counter() - t
        if rc_v != 0 or "✓ model smoke load" not in verify_out:
            fail(f"model verify {kind}: exit {rc_v}: {verify_out} {verify_err[-2000:]}")
        rc_d, header_out, _ = run_cli(["model", "dump-header", "--path", path])
        header = json.loads(header_out)
        if rc_d != 0 or header["required_keys_missing"] != [] or header["tensor_count"] != len(tensors):
            fail(f"model dump-header {kind}: exit {rc_d}, missing {header.get('required_keys_missing')}, "
                 f"{header.get('tensor_count')} tensors, want {len(tensors)}")
        smoke = next(line for line in verify_out.splitlines() if "smoke load" in line)
        print(
            f"  model export {' '.join(flags)}: {json.loads(stdout)}, {os.path.getsize(path) / 1e6:.1f} MB in {wall:.1f} s, "
            f"sha256 {got[:16]}… = the in-process exporter's; model verify (load on the card) {verify_wall:.1f} s: "
            f"{smoke}; dump-header {header['tensor_count']} tensors, required keys missing "
            f"{header['required_keys_missing']} (of {len(REQUIRED_MODEL_KEYS)})  [{CARD}]"
        )
        paths[kind] = path
    return paths


def _tar_gz(path: str, members: dict) -> None:
    import tarfile

    with tarfile.open(path, "w:gz", compresslevel=1) as tf:
        for name, source in members.items():
            tf.add(source, arcname=name)


def bundle(root: str, artifact: str, tok_path: str) -> None:
    """``model download-bundle`` of a ``file://`` tar.gz holding a
    checkpoint, the tokenizer and a ``bundle-manifest.json``, with
    ``--sha256``; the extracted files against the originals, ``model
    verify`` on them; a copy with one byte flipped is refused."""
    out = os.path.join(root, "build", "phase14")
    manifest = os.path.join(out, "bundle-manifest.json")
    originals = {"model.safetensors": artifact, "tokenizer.model": tok_path}
    digests = {name: _sha256(src) for name, src in originals.items()}
    with open(manifest, "w") as f:
        json.dump({"files": [{"path": n, "sha256": d} for n, d in digests.items()]}, f)
    archive = os.path.join(out, "bundle.tar.gz")
    t = time.perf_counter()
    _tar_gz(archive, {**originals, "bundle-manifest.json": manifest})
    pack = time.perf_counter() - t
    digest = _sha256(archive)
    dest = os.path.join(out, "bundle")
    t = time.perf_counter()
    rc, stdout, stderr = run_cli(["model", "download-bundle", "--bundle-url", f"file://{archive}", "--sha256", digest,
                                  "--out-dir", dest])
    wall = time.perf_counter() - t
    if rc != 0 or json.loads(stdout)["files"] != 2:
        fail(f"model download-bundle: exit {rc}: {stdout} {stderr[-2000:]}")
    for name, want in digests.items():
        if _sha256(os.path.join(dest, name)) != want:
            fail(f"download-bundle: {name} differs from its original")
    rc_v, verify_out, verify_err = run_cli(["model", "verify", "--paths-model-path", os.path.join(dest, "model.safetensors"),
                                            "--paths-tokenizer-model", os.path.join(dest, "tokenizer.model")])
    if rc_v != 0:
        fail(f"model verify of the extracted bundle: exit {rc_v}: {verify_out} {verify_err[-2000:]}")
    corrupt = os.path.join(out, "corrupt.tar.gz")
    with open(archive, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(corrupt, "wb") as f:
        f.write(data)
    refused_dest = os.path.join(out, "refused")
    rc_c, _, err_c = run_cli(["model", "download-bundle", "--bundle-url", f"file://{corrupt}", "--sha256", digest,
                              "--out-dir", refused_dest])
    if rc_c == 0 or "checksum mismatch" not in err_c or os.path.exists(os.path.join(refused_dest, "model.safetensors")):
        fail(f"download-bundle accepted a corrupted archive: exit {rc_c}: {err_c[-2000:]}")
    print(
        f"  model download-bundle file:// tar.gz ({os.path.getsize(archive) / 1e6:.1f} MB, packed in {pack:.1f} s): "
        f"{json.loads(stdout)} in {wall:.1f} s, both files' sha256 = the originals', model verify exit 0; "
        f"a copy with one byte flipped refused (exit {rc_c}: {err_c.strip().splitlines()[-1][:90]})  [{CARD}]"
    )


def bench_cli(model_path: str, tok_path: str, frames: int, what: str, env: dict) -> dict:
    """``bench --runs 3 --json`` through the CLI in process; checks each
    run and prints the readings."""
    with _Env(POCKETTTS_PATHS_MODEL_PATH=model_path, POCKETTTS_PATHS_TOKENIZER_MODEL=tok_path,
              POCKETTTS_RUNTIME_DTYPE="bfloat16", POCKETTTS_RUNTIME_SEED=str(SEED), POCKETTTS_EOS_THRESHOLD="1e9",
              **env):
        rc, stdout, stderr = run_cli(["bench", "--text", TOOLS_TEXT, "--runs", "3", "--json"])
    if rc != 0:
        fail(f"bench {what}: exit {rc}: {stderr[-2000:]}")
    out = json.loads(stdout)
    runs = out["runs"]
    if [r["cold"] for r in runs] != [True, False, False, False]:
        fail(f"bench {what}: runs {[(r['run'], r['cold']) for r in runs]}, want a cold run then 3")
    for r in runs:
        if abs(r["audio_seconds"] - frames * 0.08) > 1e-9 or not 0 < r["ttfa_seconds"] <= r["synth_seconds"]:
            fail(f"bench {what}: run {r}: want {frames} frames ({frames * 0.08:.2f} s) and TTFA <= synth time")
    warm = [r["x_realtime"] for r in runs[1:]]
    print(
        f"  bench {what}, {frames} frames a run: rtf min/mean/max {out['rtf_min']:.4f}/{out['rtf_mean']:.4f}/"
        f"{out['rtf_max']:.4f}, x real time {min(warm):.2f}–{max(warm):.2f} (cold {runs[0]['x_realtime']:.2f}), "
        f"TTFA p50 {out['ttfa_p50_seconds'] * 1e3:.1f} ms (cold {runs[0]['ttfa_seconds'] * 1e3:.1f})  [{CARD}]"
    )
    return out


def stageprof_cli(root: str, model_path: str, tok_path: str, frames: int) -> None:
    """``stageprof --trace-dir`` through the CLI in process on the single
    runtime: the stage table, and the Chrome trace naming kernel 1's and
    kernel 2's CUDA symbols."""
    trace_dir = os.path.join(root, "build", "phase14", "trace")
    with _Env(POCKETTTS_PATHS_MODEL_PATH=model_path, POCKETTTS_PATHS_TOKENIZER_MODEL=tok_path,
              POCKETTTS_RUNTIME_DTYPE="bfloat16", POCKETTTS_RUNTIME_SEED=str(SEED), POCKETTTS_EOS_THRESHOLD="1e9"):
        rc, _, stderr = run_cli(["stageprof", "--text", TOOLS_TEXT])  # warm
        t = time.perf_counter()
        rc2, stdout, stderr2 = run_cli(["stageprof", "--text", TOOLS_TEXT, "--trace-dir", trace_dir])
        wall = time.perf_counter() - t
    if rc != 0 or rc2 != 0:
        fail(f"stageprof: exit {rc}/{rc2}: {stderr[-1000:]} {stderr2[-1000:]}")
    table = stdout.strip().splitlines()
    stages = {line.split()[0]: float(line.split()[1]) for line in table[1:-1]}
    if list(stages) != ["prepare", "prefill", "ar", "decode", "generate", "encode"] or not table[-1].endswith(
        f"audio={frames * 0.08:.2f}s"
    ):
        fail(f"stageprof table: {table}")
    path = os.path.join(trace_dir, "stageprof.trace.json")
    with open(path) as f:
        trace = f.read()
    symbols = {"kernel 1 (split_kv_attention)": "split_kv_attention", "kernel 2 (up_tail_mma_kernel)": "up_tail_mma_kernel"}
    missing = [k for k, sym in symbols.items() if sym not in trace]
    if missing:
        fail(f"stageprof trace {path} does not name {missing}")
    print(
        f"  stageprof (single runtime, bf16, {frames} frames, under torch.profiler): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; {table[-1]}; Chrome trace {os.path.getsize(path) / 1e6:.1f} MB names kernels 1 and 2; {wall:.1f} s wall  [{CARD}]"
    )


def staged_f32(tokens, frames: int) -> None:
    """``generate_audio_staged`` against ``generate_audio`` in float32 at
    temperature 0, on the card."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

    _arch, model32 = build_model(torch.float32)
    rt = GPURuntime(model32, dtype=torch.float32, seed=SEED, device="cuda")
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=frames)
    staged, stages = rt.generate_audio_staged(tokens, cfg)
    whole = rt.generate_audio(tokens, cfg)
    check_audio(staged, frames, "staged float32", bounded=False)
    err = float(np.abs(staged - whole).max())
    if err > PCM16_STEP:
        fail(f"staged float32 against generate_audio: max abs {err:.3e} > one PCM16 step {PCM16_STEP:.3e}")
    print(
        f"  generate_audio_staged float32, temperature 0, {frames} frames: max abs to generate_audio {err:.3e} "
        f"(one PCM16 step {PCM16_STEP:.3e}), RMS {float(np.sqrt(np.mean((staged - whole) ** 2))):.3e}; stages "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stages.items())
        + f"  [{CARD}]"
    )


def microbench_subprocess(root: str) -> None:
    env = {**os.environ, "PYTHONPATH": root}
    cmd = [sys.executable, "-m", "go_pocket_tts_tpu_torch.bench.microbench"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 7 or not lines[0].startswith(f"card: {CARD}"):
        fail(f"microbench exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    for line in lines:
        print(f"    {line}")
    print(f"  microbench subprocess: the card line and 6 ops, exit 0, {wall:.1f} s wall  [{CARD}]")


def cli_tools(fixtures, root: str) -> None:
    """Phase 14. Its launches are read into a dict of their own: the kernel
    table's totals stay those of phases 3, 5, 7 and 9."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.config import AUTOTUNE_BURST_STEPS
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer

    model_path, tok_path = fixtures
    (ids, frames), = chunk_frames(load_tokenizer(tok_path), TOOLS_TEXT)
    t0 = time.perf_counter()
    doctor = _doctor_start(root, model_path, tok_path)
    counts: dict = {}
    paths = exports(root, model_path, tok_path)
    bundle(root, paths["int4"], tok_path)
    _doctor_check(doctor, t0)

    torch.cuda.synchronize()
    kernels.reset_launches()
    bench_cli(model_path, tok_path, frames, "over the single runtime (bf16)", {})
    read_launches("phase 14's bench over the single runtime", ("decode_attention_step", "fused_up2_res",
                  "fused_seanet_up_tail"), counts, shapes=None)
    serving = dict(POCKETTTS_RUNTIME_BATCH_SLOTS="8", POCKETTTS_RUNTIME_QUANTIZE="true",
                   POCKETTTS_RUNTIME_KV_QUANTIZE="true", POCKETTTS_RUNTIME_STEPS_PER_SYNC_BURST=str(AUTOTUNE_BURST_STEPS))
    torch.cuda.synchronize()
    kernels.reset_launches()
    bench_cli(model_path, tok_path, frames, "over the 8-slot int8 batcher (int8 weights and KV, 64-step bursts)", serving)
    read_launches("phase 14's bench over the batcher", ("batched_decode_attention_int8", "quantized_matmul",
                  "fused_up2_res", "fused_seanet_up_tail"), counts, shapes=None)
    torch.cuda.synchronize()
    kernels.reset_launches()
    stageprof_cli(root, model_path, tok_path, frames)
    read_launches("phase 14's stageprof", ("decode_attention_step", "fused_up2_res", "fused_seanet_up_tail"),
                  counts, shapes=None)
    staged_f32(ids, frames)
    torch.cuda.empty_cache()
    microbench_subprocess(root)
    print(f"  phase 14 launches: {counts}")


# -- phase 15: the kernel API, the torch and cli backends, parity, stateless --------

KERNEL_API_LAUNCHES = ("decode_attention_step", "fused_up2_res", "fused_seanet_up_tail", "fused_up2_up3_tail")


def _kernel_synth(kernel, text: str, **kw):
    """``PocketTTSKernel.synthesize`` at temperature 0, EOS off: (PCM,
    progress calls, wall seconds)."""
    from go_pocket_tts_tpu_torch.utils.wav import decode_wav

    calls = []
    if kw.pop("progress", False):
        kw["progress"] = lambda done, total: calls.append((done, total))
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = kernel.synthesize(text, temperature=0.0, eos_threshold=1e9, **kw)
    wall = time.perf_counter() - t
    pcm, rate = decode_wav(data)
    if rate != 24000 or not len(pcm) or len(pcm) % 1920:
        fail(f"PocketTTSKernel: {rate} Hz, {len(pcm)} samples")
    return pcm, calls, wall


def _check_progress(calls, frames: int, what: str) -> None:
    dones = [d for d, _ in calls]
    if len(calls) < 2 or calls[-1] != (frames, frames) or dones != sorted(dones) or any(d > t for d, t in calls):
        fail(f"{what}: progress calls {calls}, want rising to ({frames}, {frames})")


def f32_service(model_path: str, tok_path: str, backend: str = "gpu", device: str = "cuda"):
    """``Service.from_config`` in float32 at temperature 0, EOS off."""
    from go_pocket_tts_tpu_torch.tts.service import Service

    cfg = entry_config(model_path, tok_path, batch_slots=1, temperature=0.0)
    cfg.runtime.dtype, cfg.runtime.device, cfg.tts.backend = "float32", device, backend
    return Service.from_config(cfg)


def kernel_api(fixtures, arch, counts: dict) -> None:
    """(a) and (b): ``PocketTTSKernel`` from bytes."""
    from go_pocket_tts_tpu_torch import kernels
    from go_pocket_tts_tpu_torch.kernel import PocketTTSKernel
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer
    from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors

    model_path, tok_path = fixtures
    with open(model_path, "rb") as f:
        model_bytes = f.read()
    with open(tok_path, "rb") as f:
        tok_bytes = f.read()
    text = STREAM_TEXTS[1]

    k32 = PocketTTSKernel(seed=SEED)
    t = time.perf_counter()
    k32.load_model(model_bytes, tok_bytes)
    print(f"  PocketTTSKernel float32 load_model from {len(model_bytes) / 1e6:.1f} MB of bytes in "
          f"{time.perf_counter() - t:.1f} s  [{CARD}]")
    one_shot, _, _ = _kernel_synth(k32, text)
    streamed, calls, _ = _kernel_synth(k32, text, progress=True)
    svc = f32_service(model_path, tok_path)
    try:
        want = svc.synthesize(k32.normalize(text))
    finally:
        svc.close()
    frames = len(want) // 1920
    if one_shot.shape != want.shape or streamed.shape != want.shape:
        fail(f"PocketTTSKernel float32: {one_shot.shape} / {streamed.shape} samples, want {want.shape}")
    _check_progress(calls, frames, "PocketTTSKernel float32 progress")
    rms_check(one_shot, want, "f32 real_arch, PocketTTSKernel one-shot WAV - Service.synthesize", tol=PCM16_STEP)
    rms_check(streamed, want, "f32 real_arch, PocketTTSKernel progress route WAV - Service.synthesize")
    del k32
    torch.cuda.empty_cache()

    kb = PocketTTSKernel(dtype="bfloat16", seed=SEED)
    kb.load_model(model_bytes, tok_bytes)
    _kernel_synth(kb, STREAM_TEXTS[0])  # warm-up
    _kernel_synth(kb, STREAM_TEXTS[0], progress=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    for route, kw in (("one-shot", {}), ("progress", {"progress": True})):
        pcm, calls, wall = _kernel_synth(kb, text, **kw)
        secs = len(pcm) / 24000
        if route == "progress":
            _check_progress(calls, len(pcm) // 1920, "PocketTTSKernel bfloat16 progress")
        print(f"  PocketTTSKernel bfloat16 {route}: {len(pcm) // 1920} frames in {wall * 1e3:.1f} ms  "
              f"x{secs / wall:.2f} real time" + (f"; progress calls {calls}" if calls else "") + f"  [{CARD}]")

    # (b) continuity over three chunks, with and without progress; voice
    # bytes of both kinds.
    chunks = chunk_frames(load_tokenizer(tok_path), SERVICE_TEXT)
    frames = sum(f for _, f in chunks)
    for kw in ({"continuity": True}, {"continuity": True, "progress": True}):
        pcm, calls, wall = _kernel_synth(kb, SERVICE_TEXT, **kw)
        check_audio(pcm, frames, f"PocketTTSKernel continuity {kw}")
        if calls:
            _check_progress(calls, frames, "PocketTTSKernel continuity progress")
        print(f"  PocketTTSKernel bfloat16 continuity over {len(chunks)} chunks"
              f"{' with progress (' + str(len(calls)) + ' calls)' if calls else ''}: {frames} frames in "
              f"{wall * 1e3:.1f} ms  x{frames * 1920 / 24000 / wall:.2f} real time  [{CARD}]")
    plain, _, _ = _kernel_synth(kb, text)
    state = synthetic_voice_state(arch, 48, 40)
    voices = {
        "embedding": encode_tensors(
            {"audio_prompt": (np.random.RandomState(SEED + 9).randn(32, arch.d_model) * 0.02).astype(np.float32)}
        ),
        "model_state": encode_tensors(
            {f"{name}/{key}": value for name, module in state.modules.items() for key, value in module.items()}
        ),
    }
    for kind, voice in voices.items():
        pcm, _, wall = _kernel_synth(kb, text, voice=voice)
        check_audio(pcm, len(plain) // 1920, f"PocketTTSKernel voice {kind}")
        if not np.abs(pcm - plain).max() > 0:
            fail(f"PocketTTSKernel voice {kind}: the voice did not change the audio")
        print(f"  PocketTTSKernel bfloat16 voice bytes ({kind}, {len(voice)} bytes): {len(pcm)} samples in "
              f"{wall * 1e3:.1f} ms  [{CARD}]")
    read_launches("the PocketTTSKernel routes", KERNEL_API_LAUNCHES, counts, shapes=None)


def torch_backend(fixtures, text: str) -> None:
    """(c) and (d): ``--backend torch`` on the card against the gpu backend
    and against itself on the CPU; ``run_parity_case`` over both."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig
    from go_pocket_tts_tpu_torch.tts import parity
    from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime

    model_path, tok_path = fixtures
    pcm, first = {}, {}
    for backend, device in (("torch", "cuda"), ("torch", "cpu"), ("gpu", "cuda")):
        svc = f32_service(model_path, tok_path, backend, device)
        try:
            if backend == "torch" and not (isinstance(svc.runtime, TorchRuntime) and svc.runtime.device.type == device):
                fail(f"--backend torch on {device}: runtime {type(svc.runtime).__name__}")
            t = time.perf_counter()
            pcm[(backend, device)] = svc.synthesize(text)
            wall = time.perf_counter() - t
            if backend == "torch":
                # One frame: the oracle's arithmetic before the AR loop feeds
                # a frame back.
                (ids, _frames), = chunk_frames(svc.tokenizer, text)
                first[device] = svc.runtime.generate_audio(ids, GenerateConfig(temperature=0.0, eos_threshold=1e9,
                                                                               max_steps=1))
        finally:
            svc.close()
        print(f"  --backend {backend} on {device}: {len(pcm[(backend, device)])} samples in {wall:.2f} s  [{CARD}]")
    check_audio(pcm[("torch", "cuda")], len(pcm[("gpu", "cuda")]) // 1920, "--backend torch on the card")
    rms_check(pcm[("torch", "cuda")], pcm[("gpu", "cuda")], "f32 real_arch, --backend torch (card) - --backend gpu")
    rms_check(first["cuda"], first["cpu"], "f32 real_arch, --backend torch, one frame, card - CPU", tol=1e-5)
    diff = (pcm[("torch", "cuda")].astype(np.float64) - pcm[("torch", "cpu")]).reshape(-1, 1920)
    per_frame = np.sqrt(np.mean(diff**2, axis=1))
    print(f"  --backend torch, card - CPU, RMS per frame: frame 0 {per_frame[0]:.3e}, frame 9 {per_frame[9]:.3e}, "
          f"last {per_frame[-1]:.3e} (the AR loop feeds each frame's float32 sum-order difference back)  [{CARD}]")
    rms_check(pcm[("torch", "cuda")], pcm[("torch", "cpu")], "f32 real_arch, --backend torch, whole request, card - CPU")

    snaps = parity.run_parity_case(
        {name: functools.partial(f32_service, model_path, tok_path, name) for name in ("gpu", "torch")}, text
    )
    out = os.path.join(os.path.dirname(model_path), "..", "phase15")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "parity_snapshots.json")
    parity.save_snapshots(path, snaps)
    if parity.load_snapshots(path) != snaps:
        fail("parity snapshots: the save/load round trip changed them")
    g, o = snaps["gpu"], snaps["torch"]
    if (g.num_chunks, g.num_samples) != (o.num_chunks, o.num_samples) or abs(g.rms - o.rms) > 1e-3:
        fail(f"run_parity_case: gpu {g} against torch {o}")
    for s in (g, o):
        print(f"  run_parity_case {s.backend}: chunks {s.num_chunks} samples {s.num_samples} peak {s.peak_abs:.6f} "
              f"rms {s.rms:.6f} pcm16 sha256 {s.pcm_sha256[:16]}…  [{CARD}]")


def fixture_replay(fixtures, arch, counts: dict) -> None:
    """(e): a fixture from ``scripts/torch_dump_parity.py`` on the CPU,
    replayed by ``verify_fixture`` on the card's float32 model."""
    import importlib.util

    from go_pocket_tts_tpu_torch.models.model import load_model
    from go_pocket_tts_tpu_torch.tts.parity_fixture import load_fixture, verify_fixture

    model_path, _ = fixtures
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("torch_dump_parity", os.path.join(root, "scripts", "torch_dump_parity.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = os.path.join(root, "build", "phase15", "oracle_fixture.json")
    t = time.perf_counter()
    if script.main(["--model", model_path, "--num-heads", str(arch.num_heads), "--device", "cpu", "--output", out]) != 0:
        fail("scripts/torch_dump_parity.py failed")
    dump = time.perf_counter() - t
    from go_pocket_tts_tpu_torch import kernels

    model = load_model(model_path, num_heads=arch.num_heads, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    reports = verify_fixture(model, load_fixture(out))
    replay = time.perf_counter() - t
    read_launches("verify_fixture", ("decode_attention_step",), counts, shapes=None)
    for r in reports:
        print(f"    {'ok' if r.passed else 'FAIL'} {r.name}: max abs {r.max_abs_err:.3e} max rel {r.max_rel_err:.3e}")
    if len(reports) != 10 or not all(r.passed for r in reports):
        fail(f"verify_fixture on the card: {[r.name for r in reports if not r.passed]} failed of {len(reports)}")
    print(f"  fixture dumped on the CPU in {dump:.1f} s, replayed on the card in {replay:.2f} s: "
          f"{len(reports)} reports, all ok  [{CARD}]")
    del model
    torch.cuda.empty_cache()


STUB_BINARY = """#!{python}
import json, os, sys
here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "argv.jsonl"), "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1:] == ["--version"]:
    print("pocket-tts stub 1.0")
    sys.exit(0)
sys.stdout.buffer.write(open(os.path.join(here, "stub.wav"), "rb").read())
"""


def _stub_argv(stub: str) -> list:
    path = os.path.join(os.path.dirname(stub), "argv.jsonl")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    os.remove(path)
    return lines


def cli_backend(root: str) -> None:
    """(f): the ``cli`` backend through a stub ``pocket-tts`` binary: ``serve
    --backend cli`` answers ``POST /tts`` with the stub's WAV, ``doctor
    --backend cli`` probes the binary, ``synth --tts-arg k=v`` passes
    ``--k=v``."""
    import signal
    import socket
    import urllib.request

    from go_pocket_tts_tpu_torch.utils.wav import decode_wav, encode_wav

    out = os.path.join(root, "build", "phase15", "cli")
    os.makedirs(out, exist_ok=True)
    stub = os.path.join(out, "pocket-tts")
    if os.path.exists(os.path.join(out, "argv.jsonl")):
        os.remove(os.path.join(out, "argv.jsonl"))
    stub_wav = encode_wav((np.sin(np.arange(9600) / 9.0) * 0.3).astype(np.float32))
    with open(os.path.join(out, "stub.wav"), "wb") as f:
        f.write(stub_wav)
    with open(stub, "w") as f:
        f.write(STUB_BINARY.format(python=sys.executable))
    os.chmod(stub, 0o755)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": root}
    cmd = [sys.executable, "-m", "go_pocket_tts_tpu_torch", "serve", "--backend", "cli", "--tts-cli-path", stub,
           "--server-listen-addr", f"127.0.0.1:{port}"]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        while True:
            try:
                if _get_json(f"{url}/health").get("status") == "ok":
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() - t > 120:
                fail(f"serve --backend cli did not come up: {proc.communicate()[1][-2000:]}")
            time.sleep(0.2)
        ready = time.perf_counter() - t
        body = _post(f"{url}/tts", "Hello world.")
        got, want = decode_wav(body)[0], decode_wav(stub_wav)[0]
        # The server encodes the stub's decoded PCM again: within one PCM16 step.
        if got.shape != want.shape or not np.abs(got - want).max() <= PCM16_STEP:
            fail("serve --backend cli: POST /tts did not answer with the stub's PCM")
        argv = _stub_argv(stub)
        if argv != [["generate", "--text", "Hello world.", "--output-path", "-", "--quiet"]]:
            fail(f"serve --backend cli: the stub saw {argv}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    print(f"  serve --backend cli: up in {ready:.1f} s, POST /tts answered with the stub's WAV "
          f"({len(body)} bytes), stub argv {argv[0]}; SIGTERM exit {proc.returncode}  [{CARD}]")

    rc, stdout, stderr = run_cli(["doctor", "--backend", "cli", "--tts-cli-path", stub])
    probe = [line for line in stdout.splitlines() if "pocket-tts binary" in line]
    if probe != ["✓ pocket-tts binary — pocket-tts stub 1.0"]:
        fail(f"doctor --backend cli: probe lines {probe} (exit {rc}): {stdout[-2000:]} {stderr[-2000:]}")
    _stub_argv(stub)
    print(f"  doctor --backend cli (exit {rc}): {probe[0]}  [{CARD}]")

    wav_out = os.path.join(out, "synth.wav")
    rc, _, stderr = run_cli(["synth", "--backend", "cli", "--tts-cli-path", stub, "--text", "Hello world.",
                             "--tts-arg", "k=v", "--out", wav_out])
    argv = _stub_argv(stub)
    with open(wav_out, "rb") as f:
        written = decode_wav(f.read())[0]
    same = written.shape == want.shape and np.abs(written - want).max() <= PCM16_STEP
    if rc != 0 or len(argv) != 1 or argv[0][-1] != "--k=v" or not same:
        fail(f"synth --backend cli --tts-arg k=v: exit {rc}, stub argv {argv}, stub's PCM {same}: {stderr[-2000:]}")
    rc, _, stderr = run_cli(["synth", "--text", "Hello world.", "--tts-arg", "k=v", "--out", wav_out])
    if rc != 2 or "only supported with --backend cli" not in stderr:
        fail(f"synth --tts-arg without --backend cli: exit {rc}: {stderr[-2000:]}")
    print(f"  synth --backend cli --tts-arg k=v: stub argv {argv[0]}, the stub's PCM written; without "
          f"--backend cli refused with exit 2  [{CARD}]")


def stateless_on_card(arch, counts: dict) -> None:
    """(g): ``flow_main`` on the card against the cached path (a prefill,
    then one decode-attention step per frame), float32."""
    from go_pocket_tts_tpu_torch.models import flow_lm as flm
    from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
    from go_pocket_tts_tpu_torch.models.params import apply_linear

    _arch, model = build_model(torch.float32)
    flow, cfg = model.params["flow_lm"], model.config.flow_lm
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, arch.n_bins, (1, 24), generator=gen, device="cuda")
    seq = torch.randn((1, 16, arch.latent_dim), generator=gen, device="cuda")
    seq[:, 0] = float("nan")
    from go_pocket_tts_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.inference_mode():
        emb = flm.text_embeddings(flow, ids)
        t = time.perf_counter()
        last, eos = flm.flow_main(flow, cfg, seq, emb)
        torch.cuda.synchronize()
        stateless = time.perf_counter() - t
        cache = flm.prompt(flow, cfg, ftr.init_kv_cache(cfg.transformer, 1, 64, device="cuda"), emb)
        for i in range(seq.shape[1]):
            x = apply_linear(flow["input_linear"], flm._replace_nan_with_bos(seq[:, i : i + 1], flow["bos_emb"]))
            y, cache = ftr.transformer_forward_cached(flow["transformer"], cfg.transformer, cache, x)
        want_last, want_eos = flm._hidden_and_eos(flow, y)
        noise = flm.sample_noise(gen, 4096, arch.latent_dim, 0.7)
    read_launches("flow_main's cached reference", ("decode_attention_step",), counts, shapes=None)
    err = max((last - want_last).abs().max().item(), (eos - want_eos).abs().max().item())
    std = noise.std().item()
    print(f"  flow_main (24 text + 16 frames) on the card in {stateless * 1e3:.1f} ms; against the cached path: "
          f"max abs {err:.3e} (tolerance 1e-4); sample_noise std {std:.4f} at T=0.7 (sqrt 0.83666)  [{CARD}]")
    if not err <= 1e-4:
        fail(f"flow_main against the cached path: max abs {err}")
    if abs(std - 0.7 ** 0.5) > 0.03 * 0.7 ** 0.5:
        fail(f"sample_noise: std {std} at T=0.7")
    del model
    torch.cuda.empty_cache()


def last_entry_points(fixtures, root: str) -> None:
    """Phase 15. Its launches are read into a dict of their own: the kernel
    table's totals stay those of phases 3, 5, 7 and 9."""
    arch, _ = checkpoint()
    counts: dict = {}
    kernel_api(fixtures, arch, counts)
    torch_backend(fixtures, STREAM_TEXTS[0])
    fixture_replay(fixtures, arch, counts)
    cli_backend(root)
    stateless_on_card(arch, counts)
    print(f"  phase 15 launches: {counts}")


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
    counts: dict = {}

    print("phase 2: kernels against their plain versions")
    check_decode_attention(rows)
    check_seanet(rows)
    check_batched_decode_attention(rows)
    check_quantized_matmul(rows)
    check_int4_matmul(rows)
    check_up2(rows)

    t = time.perf_counter()
    arch, model = build_model(torch.bfloat16)
    print(f"  real_arch bf16 weights built and loaded in {time.perf_counter() - t:.1f} s")
    print("phase 3: single-utterance path (real_arch, bfloat16)")
    main_path(model, arch, counts)

    print("phase 4: float32 path, kernels against plain versions")
    arch, model32 = build_model(torch.float32)
    f32_parity(model32, arch)

    print("phase 5: batched serving (real_arch, bfloat16, int8 weights)")
    x_int8 = batched_serving(model, arch, counts)

    print("phase 6: float32 batcher against the single runtime and against plain versions")
    int8_one_shot = f32_batched_parity(model32, arch)

    print("phase 7: int4 serving from an exported artifact (real_arch, bfloat16)")
    model4_f32 = int4_serving(model32, arch, counts, x_int8)

    print("phase 8: float32 int4 + int8-KV batcher, kernels against plain versions")
    f32_int4_parity(model4_f32, arch)
    del model4_f32
    torch.cuda.empty_cache()

    print("phase 9: frame streaming, sessions and voice conditioning (real_arch, bfloat16)")
    streaming(model, arch, counts)

    print("phase 10: float32 streaming against generate_audio and against plain versions")
    f32_streaming(model32, arch)
    del model32
    torch.cuda.empty_cache()

    print("the SEANet kernels' device time on the paths of phases 3, 5, 7 and 9 (bfloat16)")
    path_device_times(rows)

    print("phase 11: the entry points: Service, HTTP server and CLI (real_arch, bfloat16)")
    t = time.perf_counter()
    fixtures = entry_points(model, root)
    print(f"  phase 11 took {time.perf_counter() - t:.1f} s  [{CARD}]")

    print("phase 12: batched serving, whole: streams, voices, sessions, cancel, HTTP (real_arch, bfloat16)")
    t = time.perf_counter()
    batched_serving_whole(model, arch, fixtures, int8_one_shot)
    print(f"  phase 12 took {time.perf_counter() - t:.1f} s  [{CARD}]")
    print("the SEANet kernels' device time on phase 12's paths (bfloat16)")
    path_device_times(rows, PHASE12_SHAPES, "phase12_path")

    print("phase 13: voice cloning: encoder, export-voice, POST /voices, voiced synthesis (real_arch)")
    t = time.perf_counter()
    voice_cloning(model, arch, fixtures, root)
    print(f"  phase 13 took {time.perf_counter() - t:.1f} s  [{CARD}]")

    print("phase 14: the CLI's tools: doctor, model export/verify/dump-header/download-bundle, bench, stageprof, microbench")
    t = time.perf_counter()
    del model
    torch.cuda.empty_cache()
    cli_tools(fixtures, root)
    print(f"  phase 14 took {time.perf_counter() - t:.1f} s  [{CARD}]")

    print("phase 15: the last entry points: PocketTTSKernel, --backend torch and cli, parity harness and fixture, "
          "flow_main")
    t = time.perf_counter()
    last_entry_points(fixtures, root)
    print(f"  phase 15 took {time.perf_counter() - t:.1f} s  [{CARD}]")

    for name, row in rows.items():
        row["launches"] = counts.get(name, 0)
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
