#!/usr/bin/env python3
"""Where a chunk's time goes in the SSD backward's wgmma walk, and how many
of its clusters a card holds at once, on one NVIDIA card.

    python3 tools/ssd_bwd_phases.py        # from the repository root

Builds a copy of ``src/repro_torch/csrc/ssd_bwd.cu`` with a clock64() mark
after each phase of ``ssd_bwd_wgmma_kernel``'s chunk (the marks and the
phases' names below), read by lane 0 of warps 0 and 1 of every block and
summed over the blocks with one atomic add a mark (warp 0 takes dcum
while warps 1-3 sum the cluster's rows, so the two read differently at the
end of a chunk). Runs it through ``ssd_bwd_cuda`` at ``check_ssd_bwd``'s
timed shapes (the training shape B=8, S=512, H=32; a mamba2 rank's 16
heads; a batch-1 2048-token sequence; P=64, N=128, bf16, dt fp32), each
call's gradients held to ``chip_smoke.py``'s rule, and prints the mean
cycles a chunk each phase takes for one warpgroup (a head). It also asks
``cudaOccupancyMaxActiveClusters`` how many clusters of 8, 4, 2 and 1
blocks of one warpgroup fit the card at once, with the shared memory of one
block an SM (223,008 B) and of two (104,224 B), and at the walk's own
launch (two warpgroups, ``wg_smem_bytes``). Prints the card's line, one
line a reading and, last, the cycles as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ and tools/ on the path)

OUT = ROOT / "build" / "ssd_bwd_phases"
# (text after which a mark goes, phase that the mark ends)
MARKS = (
    ("    const float total = expf(cum[kQ - 1]);\n\n    // 1. rows j",
     "top: s's tile, scalars, copies landed, cluster wait"),
    ("    // 2. rows i: dy x^T", "1: B C^T, x dy^T, B g^T, L, K sums, dxdt"),
    ("      if (hb == 2) bar_sync(1, kAll);   // both s tiles are read\n",
     "2: dy x^T, DXL, dC"),
    ("    // 3. rows j: dB", "2: dC's pair sum and pushes"),
    ("    // 4. the state's rows", "3: dB, its pair sum and pushes"),
    ("    cluster_arrive();                 // this block's pushes are done\n",
     "4: g's update"),
    ("    __syncthreads();   // the tiles are read; the row dots are complete"
     "\n", "row dots, barrier"),
    ("    // 5. the block's own rows",
     "next copies, g's tile, dcum (warp 0)"),
    ("    cluster_wait();                   // the other block's pushes are "
     "here\n", "cluster wait"),
    ("    cluster_arrive();                 // done reading the pushed rows\n",
     "5: the rows' sums written (warps 1-3)"),
    ("    __syncthreads();                  // the stages are read\n",
     "end barrier"),
)
SHAPES = (("training", 8, 512, 32), ("rank-train-h16", 8, 512, 16),
          ("long", 1, 2048, 32))
CALLS = 10


def instrumented(src: str) -> str:
    """``src`` with a mark after each anchor of MARKS (the mark before the
    anchor where it ends with the phase's text) and the counters' code."""
    head = "  extern __shared__ unsigned char smem_raw[];\n"
    if src.count(head) != 1:
        raise RuntimeError("ssd_bwd.cu: kernel head not found once")
    src = src.replace(head, head + "  long long tick = clock64();\n")
    for k, (anchor, _) in enumerate(MARKS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"ssd_bwd.cu: {anchor!r} found "
                               f"{src.count(anchor)} times, want 1")
        mark = f"    PHASE({k});\n"
        after = anchor.endswith("\n")
        src = src.replace(anchor, anchor + mark if after else mark + anchor)
    counters = (
        "__device__ unsigned long long ssd_bwd_cycles[2][16];\n"
        "#define PHASE(k) do { if (threadIdx.x == 0 || threadIdx.x == 32) {"
        " const long long now_ = clock64(); atomicAdd(&ssd_bwd_cycles"
        "[threadIdx.x / 32][k], static_cast<unsigned long long>(now_ - tick"
        ")); tick = now_; } } while (0)\n")
    src = src.replace('#include "wgmma.cuh"\n',
                      '#include "wgmma.cuh"\n' + counters, 1)
    return src + '''
extern "C" int ssd_bwd_read_cycles(unsigned long long* out) {
  const int e = static_cast<int>(
      cudaMemcpyFromSymbol(out, ssd_bwd_cycles, sizeof(ssd_bwd_cycles)));
  unsigned long long zero[2][16] = {};
  cudaMemcpyToSymbol(ssd_bwd_cycles, zero, sizeof(zero));
  return e;
}

extern "C" int ssd_bwd_max_clusters(int cluster, int threads, int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(264 * threads / kWg);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  const int e = set_smem(ssd_bwd_wgmma_kernel<64, 128>, 232448);
  if (e) return -e;
  const int f = static_cast<int>(cudaOccupancyMaxActiveClusters(
      &n, ssd_bwd_wgmma_kernel<64, 128>, &cfg));
  return f ? -f : n;
}

extern "C" int ssd_bwd_smem(void) { return wg_smem_bytes(64, 128); }
'''


def build():
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "ssd_bwd.cu"
    cu.write_text(instrumented((_build.CSRC / "ssd_bwd.cu").read_text()))
    lib = OUT / "ssd_bwd.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc:\n{proc.stdout}{proc.stderr}")
    _build.build(["ssd"])
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    from ssd_bwd_tolerance import grad_err
    from repro_torch.kernels.ssd import kernel_bwd, ssd_bwd_plain, ssd_cuda
    log = chip_smoke.log
    log(chip_smoke.card_line())
    lib = build()
    lib.ssd_bwd_max_clusters.argtypes = [ctypes.c_int] * 3
    for threads, smem, what in ((128, 223_008, "one warpgroup, one block an "
                                 "SM's shared memory"),
                                (128, 104_224, "one warpgroup, two blocks an "
                                 "SM's"),
                                (256, lib.ssd_bwd_smem(), "the walk's two "
                                 "warpgroups and shared memory")):
        found = {c: lib.ssd_bwd_max_clusters(c, threads, smem)
                 for c in (8, 4, 2, 1)}
        log(f"[occupancy] {what} ({threads} threads, {smem} B): most "
            f"clusters at once " + ", ".join(f"of {c}: {n} ({c * n} blocks)"
                                             for c, n in found.items()))
    fn = lib.ssd_bwd
    entry = kernel_bwd._entry()
    fn.argtypes, fn.restype = entry.argtypes, entry.restype
    orig = kernel_bwd._entry
    kernel_bwd._entry = lambda: fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(34)
    F = torch.nn.functional
    buf = (ctypes.c_ulonglong * 32)()
    out = {}
    try:
        for label, B, S, H in SHAPES:
            def randn(*shape, dtype=torch.float32):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dtype)
            x, dy = (randn(B, S, H, 64, dtype=torch.bfloat16)
                     for _ in range(2))
            dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
            Bm, Cm = (randn(B, S, 128, dtype=torch.bfloat16)
                      for _ in range(2))
            _, _, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
            want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=256)
            got = kernel_bwd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
            err = max(grad_err(g, w) for g, w in zip(got[:5], want[:5]))
            if not err <= chip_smoke.BWD_TOL["bfloat16"]:
                raise AssertionError(f"{label}: the instrumented walk's "
                                     f"||err||/||want|| {err}")
            torch.cuda.synchronize()
            lib.ssd_bwd_read_cycles(buf)          # counted from here
            for _ in range(CALLS):
                kernel_bwd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
            torch.cuda.synchronize()
            if lib.ssd_bwd_read_cycles(buf):
                raise RuntimeError("reading the counters failed")
            hb, blocks = kernel_bwd.layout(B, H, sms)
            chunks = B * H // hb * -(-S // 64) * CALLS
            out[label] = {}
            for w in (0, 1):
                cyc = [buf[16 * w + k] / chunks for k in range(len(MARKS))]
                out[label][f"warp {w}"] = dict(zip((m for _, m in MARKS),
                                                   cyc))
                log(f"[phases] {label} B={B} S={S} H={H} ({hb} head(s) a "
                    f"block, clusters of {blocks}; ||err||/||want|| "
                    f"{err:.3e}), warp {w}: {sum(cyc):.0f} cycles a chunk: "
                    + "; ".join(f"{m} {c:.0f}"
                                for (_, m), c in zip(MARKS, cyc)))
    finally:
        kernel_bwd._entry = orig
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
