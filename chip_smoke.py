"""GPU smoke run of the PyTorch port (``repro_torch``): ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
main path (``ChipServer`` serving ``cifar9_s1`` at full width beside
``mnist5``, through the megakernel and through the staged kernels), checks
the answers against the float reference, and times every kernel beside
its bound, its plain version and a PyTorch library yardstick.  Needs one
CUDA device and no arguments; exits non-zero on any failure, and without
a CUDA device or outside a checkout of the repository.

Phases: 1 environment, 2 build, 3 kernels vs plain versions, 4 end to end
(staged == megakernel == float reference), 5 serve, 6 times.  The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
POPC_PER_CLK_PER_SM = 16        # CUDA C++ Programming Guide, arithmetic
                                # instruction throughput, cc 9.0: popc
BATCH = 8
RAGGED = 5
SERVE_REQUESTS = 64
REPLACES = {
    "conv_block": "src/repro/kernels/binary_conv2x2_block.py:154",
    "xnor_matmul": "src/repro/kernels/xnor_matmul.py:137",
    "xnor_matmul_pack": "src/repro/kernels/xnor_matmul.py:123",
    "megakernel": "src/repro/kernels/megakernel.py:366",
}
SOURCES = {
    "conv_block": "src/repro_torch/csrc/conv_block.cu",
    "xnor_matmul": "src/repro_torch/csrc/xnor_matmul.cu",
    "xnor_matmul_pack": "src/repro_torch/csrc/xnor_matmul.cu",
    "megakernel": "src/repro_torch/csrc/megakernel.cu",
}


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def phase(n: int, title: str) -> None:
    print(f"\n=== phase {n}: {title}", flush=True)


class Card:
    """The card's identity and the rates the bounds divide by."""

    def __init__(self):
        self.name = torch.cuda.get_device_name(0)
        self.smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader").splitlines()[0]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        clk = sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits").splitlines()[0]
        self.clock_hz = float(clk) * 1e6
        self.popc_per_s = self.sms * POPC_PER_CLK_PER_SM * self.clock_hz

    def bound(self, nbytes: float, word_ops: float):
        """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
        xor+popc word-ops over the card's popc issue rate."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = word_ops / self.popc_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events after a warm-up (L2 stays warm, as in steady serving)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {err})")
    return err


def words(gen, *shape) -> torch.Tensor:
    """Random 32-bit words (bit 31 set in about half) as int32."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def random_image(interpreter, program, gen):
    """A weight image from init_params with spread-out BN statistics, so
    thresholds and both comparator directions occur."""
    params = interpreter.init_params(gen, program, device="cpu")
    for p in params["conv"]:
        f = p["gamma"].shape[0]
        p["gamma"] = torch.randn(f, generator=gen)
        p["beta"] = torch.randn(f, generator=gen) * 4
        p["mean"] = torch.randn(f, generator=gen) * 16
        p["var"] = torch.rand(f, generator=gen) * 100 + 1
    return interpreter.fold_params(params, program, image=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.binarize import unpack_signs
    from repro_torch.core.chip import interpreter, networks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import binary_conv2x2_block as bcb
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import xnor_matmul as xm
    from repro_torch.launch.chip_serve import build_params, frame_stream
    from repro_torch.serving.server import ChipServer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment ------------------------------------------------------
    phase(1, "environment")
    card = Card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(sh(_build.nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    print(f"devices {torch.cuda.device_count()}, {card.name}, {card.sms} SMs, "
          f"max SM clock {card.clock_hz / 1e6:.0f} MHz")
    print(f"nvidia-smi: {card.smi}")
    print(f"rates: HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); popc "
          f"{card.popc_per_s / 1e12:.3f} T word-ops/s = {card.sms} SMs x "
          f"{POPC_PER_CLK_PER_SM}/clk (CUDA guide, cc 9.0) x max SM clock")

    # -- 2. build -----------------------------------------------------------
    phase(2, "build")
    t0 = time.perf_counter()
    built = _build.build(ptxas_verbose=True)
    print(f"built {len(built)} sources in {time.perf_counter() - t0:.1f} s "
          f"(parallel nvcc)")
    for b in built.values():
        kernel, spills = None, ""
        for line in b.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                          line)
            if m and kernel:
                print(f"  {b.name}: {kernel[-40:]}: {m.group(1)} registers, "
                      f"{m.group(2) or 0} B static smem, {spills}")

    programs = {n: networks.REGISTRY[n]() for n in networks.REGISTRY}
    cifar = programs["cifar9_s1"]
    gen = torch.Generator().manual_seed(0)
    errs = {k: 0 for k in REPLACES}

    # -- 3. kernels vs plain versions --------------------------------------
    phase(3, "kernels vs plain versions, bit-exact (tolerance 0)")
    conv_shapes = []
    for name, b in (("cifar9_s1", BATCH), ("mnist5", BATCH)):
        for _, h, w, c, f, pool in (st for st in
                                    interpreter.compile_plan(
                                        programs[name]).mega
                                    if st[0] == "conv"):
            conv_shapes.append((name, b, h, w, c, f, pool))
    for name, b, h, w, c, f, pool in conv_shapes:
        a = words(gen, b, h, w, c // 32)
        wt = words(gen, f, 4, c // 32)
        tau = torch.randint(-4 * c, 4 * c + 1, (f,), generator=gen,
                            dtype=torch.int32)
        tau[0], tau[1] = -2 ** 31, 2 ** 31 - 256          # saturated neurons
        flip = torch.randint(0, 2, (f,), generator=gen, dtype=torch.int32)
        want = bcb.conv_block_body(a.to(dev), wt.to(dev), tau.to(dev),
                                   flip.to(dev), k4=4 * c, h=h, wd=w,
                                   pool=pool)
        got = bcb.binary_conv2x2_block(a.to(dev), wt.to(dev), tau.to(dev),
                                       flip.to(dev), c=c, pool=pool)
        torch.cuda.synchronize()
        errs["conv_block"] = max(errs["conv_block"], max_abs_err(got, want))
        print(f"  conv_block {name} B={b} {h}x{w} C={c} F={f} pool={pool}: "
              f"equal")
    fc_shapes = [("cifar9_s1 final", BATCH, 10, 1024, False),
                 ("mnist5 hidden", BATCH, 64, 256, True),
                 ("mnist5 final", BATCH, 10, 64, False)]
    for label, m, n, k, pack in fc_shapes:
        a, wt = words(gen, m, k // 32), words(gen, n, k // 32)
        want = xm.xnor_matmul_plain(a.to(dev), wt.to(dev), k, pack_out=pack)
        got = xm.xnor_matmul(a.to(dev), wt.to(dev), k, pack_out=pack)
        torch.cuda.synchronize()
        key = "xnor_matmul_pack" if pack else "xnor_matmul"
        errs[key] = max(errs[key], max_abs_err(got, want))
        print(f"  {key} {label} M={m} K={k} N={n}: equal")
    images = {n: random_image(interpreter, p, gen) for n, p in programs.items()}
    for name, prog in programs.items():
        plan = interpreter.compile_plan(prog)
        image = {k: v.to(dev) for k, v in images[name].items()}
        for b in (BATCH, RAGGED):
            frames = torch.from_numpy(frame_stream(prog, b, b)).to(dev)
            want = mk.megakernel_plain(image, frames, spec=plan.mega)
            got = mk.megakernel_forward(image, frames, spec=plan.mega)
            torch.cuda.synchronize()
            errs["megakernel"] = max(errs["megakernel"],
                                     max_abs_err(got, want))
        print(f"  megakernel {name} B={BATCH} and B={RAGGED}: equal")

    # -- 4. end to end -------------------------------------------------------
    phase(4, "end to end: staged == megakernel == float reference")
    artifacts, offline = {}, {}
    for i, name in enumerate(("cifar9_s1", "mnist5")):
        prog = programs[name]
        plan = interpreter.compile_plan(prog)
        params = build_params(prog, seed=i, warm_bn=True, device=dev)
        artifacts[name] = interpreter.fold_params(params, prog, packed=True)
        frames = frame_stream(prog, SERVE_REQUESTS // 2, 100 + i)
        ref_l, ref_y = interpreter.forward_infer(
            interpreter.fold_params(params, prog), prog, frames, device=dev)
        st_l, st_y = plan.forward(artifacts[name], frames, device=dev)
        mg_l, mg_y = plan.forward_mega(
            interpreter.fold_params(params, prog, image=True), frames,
            device=dev)
        for what, (lg, y) in (("staged", (st_l, st_y)),
                              ("megakernel", (mg_l, mg_y))):
            if not (torch.equal(lg, ref_l) and torch.equal(y, ref_y)):
                raise AssertionError(f"{name}: {what} != float reference")
        if not torch.isfinite(ref_l).all():
            raise AssertionError(f"{name}: non-finite logits")
        offline[name] = ref_y.cpu().numpy()
        print(f"  {name}: {len(frames)} frames, logits {tuple(ref_l.shape)}, "
              f"staged == megakernel == float reference (label counts "
              f"{np.bincount(offline[name], minlength=10).tolist()})")

    # -- 5. serve ------------------------------------------------------------
    phase(5, f"serve {SERVE_REQUESTS} requests through ChipServer "
             f"(batch {BATCH}, prefetch 2)")
    launches = {}
    for megakernel in (True, False):
        server = ChipServer({n: programs[n] for n in artifacts}, artifacts,
                            batch=BATCH, megakernel=megakernel, prefetch=2,
                            device=dev)
        streams = {n: frame_stream(programs[n], SERVE_REQUESTS // 2, 100 + i)
                   for i, n in enumerate(artifacts)}
        for j in range(SERVE_REQUESTS // 2):
            for n in artifacts:
                server.submit(n, streams[n][j])
        ops.reset_launch_counts()
        results = server.drain()
        counts = ops.launch_counts()
        server.close()
        st = server.stats()
        if st.billed != st.total_served + sum(st.padded.values()):
            raise AssertionError(f"ledger: {st.billed} billed != served + "
                                 f"padded")
        if st.total_served != SERVE_REQUESTS or len(results) != SERVE_REQUESTS:
            raise AssertionError(f"served {st.total_served} of "
                                 f"{SERVE_REQUESTS}")
        for n in artifacts:
            got = np.array([r.label for r in sorted(results,
                                                    key=lambda r: r.rid)
                            if r.program == n])
            if not np.array_equal(got, offline[n]):
                raise AssertionError(f"{n}: served labels != offline plan")
        def per_dispatch(pred):          # launches one dispatch makes
            return sum(st.variant_dispatches[n] * sum(
                1 for t in interpreter.compile_plan(programs[n]).mega
                if pred(t)) for n in artifacts)
        expect = ({"megakernel": st.dispatches} if megakernel else
                  {"conv_block": per_dispatch(lambda t: t[0] == "conv"),
                   "xnor_matmul": per_dispatch(
                       lambda t: t[0] == "fc" and not t[4]),
                   "xnor_matmul_pack": per_dispatch(
                       lambda t: t[0] == "fc" and t[4])})
        for k, v in expect.items():
            if counts[k] != v:
                raise AssertionError(f"{k}: {counts[k]} launches, want {v}")
            launches[k] = counts[k]
        mode = "megakernel" if megakernel else "staged"
        print(f"  {mode}: {st.total_served} served in {st.dispatches} "
              f"dispatches, billed {st.billed} == served + padded "
              f"{sum(st.padded.values())}; labels == offline plan; launches "
              f"{ {k: counts[k] for k in expect} }")
        print(f"  {mode}: {st.host_frames_per_s:,.0f} frames/s host "
              f"(first serve, includes warm-up), chip-model bill "
              f"{st.chip.uj_per_frame:.2f} uJ/frame, "
              f"{st.chip.frames_per_s:,.0f} frames/s at Emin [{card.smi}]")

    # -- 6. times ------------------------------------------------------------
    phase(6, f"times (CUDA events, warm L2) [{card.smi}]")
    rows = {}

    def row(name, ms, plain_ms, nbytes, word_ops, library_ms):
        bound_ms, bound_by = card.bound(nbytes, word_ops)
        rows[name] = dict(name=name, route="cuda", source=SOURCES[name],
                          replaces=REPLACES[name],
                          launches=launches[name],
                          max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
        print(f"  {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}), library "
              + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
              + f" [{card.smi}]")

    # conv_block: the 8 conv layers of one cifar9_s1 dispatch at batch 8
    conv = [s for s in conv_shapes if s[0] == "cifar9_s1"]
    ops_in = []
    for _, b, h, w, c, f, pool in conv:
        a = words(gen, b, h, w, c // 32).to(dev)
        wt = words(gen, f, 4, c // 32).to(dev)
        tau = torch.randint(-4 * c, 4 * c + 1, (f,), generator=gen,
                            dtype=torch.int32).to(dev)
        flip = torch.randint(0, 2, (f,), generator=gen,
                             dtype=torch.int32).to(dev)
        # the library yardstick reads the same bits, unpacked to +/-1 fp16
        # (sums up to 4*256 are exact): NCHW maps, (F, C, 2, 2) taps
        xh = unpack_signs(a, c).permute(0, 3, 1, 2).to(torch.float16)
        wh = unpack_signs(wt, c).reshape(f, 2, 2, c).permute(
            0, 3, 1, 2).to(torch.float16)
        ops_in.append((a, wt, tau, flip, b, h, w, c, f, pool, xh, wh))
    nbytes = word_ops = 0
    for a, wt, tau, flip, b, h, w, c, f, pool, *_ in ops_in:
        ho, wo = ((h - 1) // 2, (w - 1) // 2) if pool else (h - 1, w - 1)
        positions = 4 * ho * wo if pool else ho * wo
        nbytes += 4 * (a.numel() + wt.numel() + 2 * f + b * ho * wo * f // 32)
        word_ops += b * positions * f * 4 * (c // 32)
    row("conv_block",
        time_ms(lambda: [bcb.binary_conv2x2_block(a, wt, tau, flip, c=c,
                                                  pool=pool)
                         for a, wt, tau, flip, b, h, w, c, f, pool, *_
                         in ops_in], 50),
        time_ms(lambda: [bcb.conv_block_body(a, wt, tau, flip, k4=4 * c,
                                             h=h, wd=w, pool=pool)
                         for a, wt, tau, flip, b, h, w, c, f, pool, *_
                         in ops_in], 5),
        nbytes, word_ops,
        time_ms(lambda: [torch.nn.functional.conv2d(xh, wh)
                         for *_, xh, wh in ops_in], 50))
    for a, wt, tau, flip, b, h, w, c, f, pool, *_ in ops_in:
        ms = time_ms(lambda: bcb.binary_conv2x2_block(a, wt, tau, flip, c=c,
                                                      pool=pool), 50)
        print(f"    layer {h}x{w} C={c} pool={pool}: {ms:.4f} ms")

    for key, (label, m, n, k, pack) in (("xnor_matmul", fc_shapes[0]),
                                        ("xnor_matmul_pack", fc_shapes[1])):
        a, wt = words(gen, m, k // 32).to(dev), words(gen, n, k // 32).to(dev)
        ab = unpack_signs(a, k).to(torch.bfloat16)        # same bits, +/-1
        wb = unpack_signs(wt, k).t().contiguous().to(torch.bfloat16)
        out_words = m * (n // 32 if pack else n)
        row(key,
            time_ms(lambda: xm.xnor_matmul(a, wt, k, pack_out=pack), 200),
            time_ms(lambda: xm.xnor_matmul_plain(a, wt, k, pack_out=pack),
                    50),
            4 * (a.numel() + wt.numel() + out_words), m * n * (k // 32),
            time_ms(lambda: torch.matmul(ab, wb), 200))

    plan = interpreter.compile_plan(cifar)
    image = interpreter.ensure_image(artifacts["cifar9_s1"], cifar)
    frames = torch.from_numpy(frame_stream(cifar, BATCH, 7)).to(dev)
    io = plan.mega[0]
    nbytes = 4 * (frames.numel() + sum(v.numel() for v in image.values())
                  + io[5] // io[3] + BATCH * plan.mega[-1][2])
    smem = 2 * 4 * mk.stage_table(plan.mega, tuple(image["fw"].shape))[-1]
    print(f"  megakernel cifar9_s1: {BATCH} blocks of {mk.WARPS} warps, "
          f"{smem} B dynamic shared memory each")
    word_ops = 0
    for st in plan.mega:
        if st[0] == "conv":
            _, h, w, c, f, pool = st
            pos = 4 * ((h - 1) // 2) * ((w - 1) // 2) if pool else \
                (h - 1) * (w - 1)
            word_ops += BATCH * pos * f * 4 * (c // 32)
        elif st[0] == "fc":
            word_ops += BATCH * st[2] * -(-st[1] // 32)
    row("megakernel",
        time_ms(lambda: mk.megakernel_forward(image, frames, spec=plan.mega),
                20),
        time_ms(lambda: mk.megakernel_plain(image, frames, spec=plan.mega),
                3),
        nbytes, word_ops, None)

    for batch, n_req in ((BATCH, 128), (256, 1024)):
        server = ChipServer({"cifar9_s1": cifar},
                            {"cifar9_s1": artifacts["cifar9_s1"]},
                            batch=batch, megakernel=True, prefetch=2,
                            device=dev)
        stream = frame_stream(cifar, n_req, 300)
        for rep in range(2):                     # warm-up, then measured
            server.reset_stats()
            server.submit_many("cifar9_s1", stream)
            server.drain()
        st = server.stats()
        server.close()
        print(f"  serve cifar9_s1 megakernel batch {batch}: "
              f"{st.host_frames_per_s:,.1f} frames/s host ({n_req} frames, "
              f"{st.dispatches} dispatches, prefetch 2) [{card.smi}]")

    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(card.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card.name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
