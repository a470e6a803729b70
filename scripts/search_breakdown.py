#!/usr/bin/env python3
"""Where the codebook search's time goes on the card: variants of
fourm_torch/kernels/csrc/vq_codebook.cu with parts cut out, timed beside the
kernel at the tokenize shapes.

    python3 scripts/search_breakdown.py

Each variant is the kernel's source with a few lines replaced, built with
the port's nvcc flags into fourm_torch/kernels/_build/breakdown/ and called
through its C entry with the wrapper's plan and margin:
  kernel         the kernel as it is (its indices held to the twin);
  no scan        the candidate scan skipped: screen, tile max and threshold;
  MMA only       the ALU pass after the products cut: loads and wgmma;
  loads only     the products cut too: the TMA stream of the codes alone;
  producer warp  a ninth warp issues the loads (consumers capped at 96
                 registers) in place of thread 0;
  lazy refill    thread 0 refills without blocking (mbarrier.test_wait);
and, for the cosine search at K = 16384, the kernel with clock64() around
each part of its tile loop: the cycles a CTA's warpgroups spend waiting for
a tile, waiting for its products, in the ALU pass and in the refill. Times
are CUDA events over 20 calls after a sleep kernel (chip_smoke.time_ms). The
last line is one JSON object. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOP_TOP = "  for (int t = 0; t < nt; ++t) {\n    const int s = t % S;\n"
INIT_LOAD = "  if (threadIdx.x == 0)\n    for (int t = 0; t < min(S, nt); ++t) load_tile(t);\n"
REFILL = """    if (threadIdx.x == 0 && t > 0 && t - 1 + S < nt) {
      sm90::mbar_wait(&empty[(t - 1) % S], ((t - 1) / S) & 1);
      load_tile(t - 1 + S);
    }
"""
AFTER_MMA = "    sm90::wgmma_wait<0>();\n    sm90::fence_acc(acc);\n"
ALU_START = "\n    const int k0 = (t0 + t) * TILE;\n"
REFILL_NOTE = "    // thread 0 refills the stage of the tile before"
CUT_ALU = [(AFTER_MMA + ALU_START,
            AFTER_MMA + "    __syncwarp();\n    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n#if 0"
            + ALU_START),
           (REFILL_NOTE, "#endif\n" + REFILL_NOTE)]
MMA = ("    sm90::fence_acc(acc);\n    sm90::wgmma_fence();\n#pragma unroll\n"
       "    for (int kk = 0; kk < 4 * NB; ++kk) {")
MBAR_TEST = ("struct Args {", """\
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\\n.reg .pred p;\\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
               "selp.u32 %0, 1, 0, p;\\n}\\n" : "=r"(done) : "r"(sm90::smem_u32(bar)), "r"(parity)
               : "memory");
  return done != 0;
}

struct Args {""")
VARIANTS = {
    "kernel": [],
    "no scan": [("      if (tm[i] >= thr) {", "      if (tm[i] >= thr && a.N < 0) {")],
    "MMA only": CUT_ALU,
    "loads only": CUT_ALU + [(MMA, "#if 0\n" + MMA), (AFTER_MMA, AFTER_MMA + "#endif\n")],
    "producer warp": [
        ("__launch_bounds__(THREADS, 2)\nnearest_kernel",
         "__launch_bounds__(THREADS + 32, 2)\nnearest_kernel"),
        (INIT_LOAD, """  if (warp == THREADS / 32) {  // the producer warp
    if (lane == 0)
      for (int t = 0; t < nt; ++t) {
        if (t >= S) sm90::mbar_wait(&empty[t % S], ((t - S) / S) & 1);
        load_tile(t);
      }
    gemv::cluster_wait();
    return;
  }
"""),
        ("  sm90::mbar_wait(&xfull, 0);\n  __syncthreads();",
         "  sm90::mbar_wait(&xfull, 0);\n  asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");"),
        (REFILL, "")] + [
        (f"nearest_kernel<COSINE, {k}>, grid, THREADS,",
         f"nearest_kernel<COSINE, {k}>, grid, THREADS + 32,") for k in (1, 2, 3, 4)],
    "lazy refill": [
        MBAR_TEST,
        (INIT_LOAD, "  int next = 0;  // thread 0: the next tile to load\n  if (threadIdx.x == 0)\n"
                    "    for (; next < min(S, nt); ++next) load_tile(next);\n"),
        (LOOP_TOP, LOOP_TOP + "    if (threadIdx.x == 0 && next == t) {\n"
                              "      sm90::mbar_wait(&empty[s], ((t - S) / S) & 1);\n"
                              "      load_tile(next++);\n    }\n"),
        (REFILL, "    if (threadIdx.x == 0)\n      while (next < nt && next - S <= t &&\n"
                 "             mbar_test(&empty[next % S], ((next - S) / S) & 1))\n"
                 "        load_tile(next++);\n")],
    "clock": [
        (LOOP_TOP + "    sm90::mbar_wait(&full[s], (t / S) & 1);\n",
         "  long long T0 = 0, T1 = 0, T2 = 0, T3 = 0, Tstart = clock64();\n" + LOOP_TOP
         + "    long long c0 = clock64();\n    sm90::mbar_wait(&full[s], (t / S) & 1);\n"
           "    long long c1 = clock64();\n    T0 += c1 - c0;\n"),
        (AFTER_MMA + ALU_START, AFTER_MMA + "    long long c2 = clock64();\n    T1 += c2 - c1;\n"
         + ALU_START),
        (REFILL_NOTE, "    long long c3 = clock64();\n    T2 += c3 - c2;\n" + REFILL_NOTE),
        (REFILL + "  }\n", REFILL + "    T3 += clock64() - c3;\n  }\n"
         "  if (threadIdx.x % 128 == 0) {  // the first thread of each warpgroup\n"
         "    long long* dbg = (long long*)a.e2 + (blockIdx.x * 2 + threadIdx.x / 128) * 5;\n"
         "    dbg[0] = T0;\n    dbg[1] = T1;\n    dbg[2] = T2;\n    dbg[3] = T3;\n"
         "    dbg[4] = clock64() - Tstart;\n  }\n")],
}
PARTS = ("waiting for a tile", "waiting for its products", "ALU pass", "refill", "whole loop")


def build(_build):
    src = (_build.CSRC / "vq_codebook.cu").read_text()
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"search_breakdown: variant '{name}' no longer matches "
                                   f"vq_codebook.cu at: {old[:60]!r}")
            s = s.replace(old, new)
        stem = name.replace(" ", "_")
        (out / f"{stem}.cu").write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant '{name}':\n{log}")
        fn = ctypes.CDLL(str(out / f"{name.replace(' ', '_')}.so")).fourm_nearest_code
        fn.argtypes = _build.SIGNATURES["nearest_code"][2]
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("search_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from fourm_torch.kernels import _build
    from fourm_torch.kernels import vq_codebook as vc
    from fourm_torch.vq import l2norm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    N, D = chip_smoke.VQ_BATCH * 196, 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": card, "rows": {}}
    x = torch.randn(N, D, generator=gen, device="cuda")
    for K, cosine in ((16384, True), (8192, True), (16384, False)):
        e = torch.randn(K, D, generator=gen, device="cuda")
        xx, ee = (l2norm(x), l2norm(e)) if cosine else (x, e)
        ref = (vc.nearest_code_cosine_plain if cosine else vc.nearest_code_plain)(xx, ee)
        split, stages = vc.search_plan(N, K, D, sms)
        tiles = -(-K // vc.SEARCH_TILE)
        e2 = torch.zeros(tiles * vc.SEARCH_TILE, device="cuda")
        emax = torch.empty(tiles, device="cuda")
        out = torch.empty(N, dtype=torch.int64, device="cuda")
        row = f"{'nearest_code_cosine' if cosine else 'nearest_code'} K={K} (split {split})"
        res["rows"][row] = {}
        for name, fn in fns.items():
            def run(fn=fn):
                code = fn(xx.data_ptr(), ee.data_ptr(), e2.data_ptr(), emax.data_ptr(),
                          out.data_ptr(), N, K, D, int(cosine), split, stages,
                          vc.SCREEN_REL[cosine], vc.SCREEN_SQ, vc.SCREEN_ABS, stream)
                _build.check(name, code)

            if name == "clock":
                if not (cosine and K == 16384):
                    continue
                e2.zero_()
                run()
                torch.cuda.synchronize()
                ctas = -(-N // vc.SEARCH_ROWS) * split
                cyc = e2.view(torch.int64)[:ctas * 10].view(ctas, 2, 5).double().mean(0)
                res["rows"][row]["cycles per CTA"] = {
                    p: [float(cyc[0, i]), float(cyc[1, i])] for i, p in enumerate(PARTS)}
                print(f"{row}: cycles per CTA (warpgroup 0 / 1): " + ", ".join(
                    f"{p} {cyc[0, i]:.0f} / {cyc[1, i]:.0f}" for i, p in enumerate(PARTS)),
                    flush=True)
                continue
            out.fill_(-1)
            run()
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            if name in ("kernel", "producer warp", "lazy refill"):
                chip_smoke.check(exact, f"{row}: variant {name} differs from the twin")
            ms = chip_smoke.time_ms(torch, run, 20)
            res["rows"][row][name] = ms
            print(f"{row}: {name}: {ms:.4f} ms{'' if exact else ' (indices not kept)'}; {card}",
                  flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
