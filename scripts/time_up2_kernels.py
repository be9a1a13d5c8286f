"""The SEANet kernels on their own: kernels 7 (``fused_up2_res``), 2
(``fused_seanet_up_tail``), 8 (``fused_up2_up3_tail``) and 3
(``fused_seanet_tail``), each against its plain version and timed.

    python3 scripts/time_up2_kernels.py [--path-shapes FILE]

Needs one CUDA card and ``nvcc``. In float32 and bfloat16 at 160 frames
(B = 1), and in bfloat16 at the batcher's harvest shape (8 lanes x 256
frames), it prints each kernel's max error against its plain version and
its device time by CUDA-graph replay (kernel 8 whole, and one streamed
block of 4, 8 and 16 frames, each beside its yardstick: kernel 7 then
kernel 2 on the same input, one graph; kernel 3 beside its op chain), with
the card's name and power limit. It
uses only the wrappers' public signatures and ``chip_smoke``'s timing
helpers, so run from another checkout's root (a ``git archive`` of the
parent under ``build/``) it times that checkout's kernels: an A/B in one
call.

With ``--path-shapes FILE`` it then times each kernel (bfloat16) at every
input shape that the paths of ``chip_smoke.py`` launched it on, and prints
its device time on the paths, the sum of count x time: FILE is a JSON
object ``{kernel name: [[B, C, T, count], ...]}``, the ``path_shapes`` of
the rows of ``chip_smoke.py``'s kernel table (kernel 8 is timed in its
streaming form).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path-shapes", help="JSON {kernel: [[B, C, T, count], ...]} from chip_smoke.py's table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_up2_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from go_pocket_tts_tpu_torch.kernels import seanet_tail as st

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main: full float32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}; torch {torch.__version__}; checkout {os.getcwd()}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        up2, rest = cs._up2_inputs(gen, dtype)
        halo = torch.zeros((1, 256, st.HALO), dtype=dtype, device="cuda")
        cases = [  # (name, kernel, plain, weights, input channels, input columns a frame, timed at the harvest)
            ("kernel 7 fused_up2_res", st.fused_up2_res, st.fused_up2_res_plain, up2, 256, 96, True),
            ("kernel 2 fused_seanet_up_tail", st.fused_seanet_up_tail, st.fused_seanet_up_tail_plain, rest, 128, 480, True),
            ("kernel 3 fused_seanet_tail", st.fused_seanet_tail, st.fused_seanet_tail_plain, rest[2:], 64, 1920, False),
            ("kernel 8 fused_up2_up3_tail", st.fused_up2_up3_tail, st.fused_up2_up3_tail_plain, up2 + rest, 256, 96, False),
        ]
        for name, kernel, plain, ws, c_in, per_frame, harvest in cases:
            batches = [(1, 160)] + ([(8, 256)] if harvest and dtype == torch.bfloat16 else [])
            for b, frames in batches:
                x = (torch.randn((b, c_in, per_frame * frames), generator=gen, device="cuda") * 0.5).to(dtype)
                err = cs.max_err(kernel(x, *ws), plain(x, *ws), dtype, name)
                ms = cs.device_ms(lambda: kernel(x, *ws), per_graph=5 if b == 1 else 2)
                extra = ""
                if "kernel 3" in name:
                    extra = f"  op chain {cs.device_ms(lambda: cs._tail_op_chain(x, *ws), per_graph=5):.4f} ms"
                print(f"  {name} {cs.dname(dtype)} x={tuple(x.shape)}: max_abs_err {err:.3e}  kernel {ms:.4f} ms{extra}  [{cs.CARD}]")
            if "kernel 8" in name:
                for n in (4, 8, 16, 160):
                    xb = x[:, :, : 96 * n].contiguous()
                    start = torch.full((1,), 96 * n, dtype=torch.int32, device="cuda")
                    per_graph = 5 if n < 160 else 3
                    ms = cs.device_ms(lambda: st.fused_up2_up3_tail_stream(xb, halo, start, *ws), per_graph=per_graph)
                    yard = cs.device_ms(lambda: st.fused_seanet_up_tail(st.fused_up2_res(xb, *up2), *rest), per_graph=per_graph)
                    print(f"  {name} {cs.dname(dtype)} streamed block of {n} frames: kernel {ms:.4f} ms, "
                          f"kernels 7 + 2 {yard:.4f} ms  [{cs.CARD}]")
    if args.path_shapes:
        with open(args.path_shapes) as f:
            path_shapes = json.load(f)
        dtype = torch.bfloat16
        up2, rest = cs._up2_inputs(gen, dtype)
        weights = {
            "fused_seanet_up_tail": rest,
            "fused_seanet_tail": rest[2:],
            "fused_up2_res": up2,
            "fused_up2_up3_tail": up2 + rest,
        }
        for name, shapes in sorted(path_shapes.items()):
            total, launches = 0.0, 0
            for b, c, t, count in shapes:
                x = (torch.randn((b, c, t), generator=gen, device="cuda") * 0.5).to(dtype)
                ws = weights[name]
                if name == "fused_up2_up3_tail":
                    halo = torch.zeros((b, 256, st.HALO), dtype=dtype, device="cuda")
                    start = torch.full((b,), t, dtype=torch.int32, device="cuda")

                    def call():
                        return st.fused_up2_up3_tail_stream(x, halo, start, *ws)
                else:
                    kernel = getattr(st, name)

                    def call():
                        return kernel(x, *ws)
                ms = cs.device_ms(call, per_graph=5 if b * t <= 96 * 256 else 2)
                total += count * ms
                launches += count
            print(f"  {name} bfloat16: device time on the paths {total:.4f} ms over {launches} launches  [{cs.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
