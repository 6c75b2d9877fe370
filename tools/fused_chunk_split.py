#!/usr/bin/env python3
"""Time one fused chunk (``fused_assignment_phases`` or
``fused_ot_phases``) and split it at its grid barriers, on the chunks of
``chip_smoke.py`` phase 2.

    python3 tools/fused_chunk_split.py [--kernel assignment|ot]
                                       [--source FILE] [--seed 0]
                                       [--reps 10] [--out FILE]

The chunks are chip_smoke's own, built by its helpers from the same seed:

- ``--kernel assignment`` (the default; ``fused_assignment_chunk``,
  ``fused_assignment_full_chunk``): B = 16 lanes of 1024 x 1024 three
  stepped phases in, and B = 1 on phase 3's Fig. 1 costs (n = 10 000,
  eps = 0.01) from phase 280. To draw phase 3's points the tool replays
  chip_smoke's phase-2 draws first (``fig1_generator``).
- ``--kernel ot`` (``fused_ot_chunk``, ``fused_ot_full_chunk``): B = 8
  lanes of 512 x 512 two stepped phases in (the assignment chunk is
  drawn first from the same generator, as in chip_smoke, and dropped),
  and B = 1 at n = 4096, eps = 0.05 from the initial state (the OT
  cell's whole solve).

One k = 8 chunk each. ``--path`` picks the path of
``fused_assignment.cu`` (``grid``, ``lane`` or ``both``, one row each;
the OT kernel has the grid path only): the per-lane path runs in
clusters of the route's C (``kernels/ops.fused_assignment_route``; where
the rule takes the grid path, clusters of 8), or of ``--cluster`` blocks.
``--source`` names the ``fused_assignment.cu`` or
``fused_ot.cu`` to measure (default: this checkout's). Pass another
version's, for example the parent commit unpacked with ``git archive``,
to compare two versions on one card: one run per source, alternating.
Its headers are read from its own directory, and nothing else of its
tree is read; it must keep this checkout's C entry point
(``kernels/ops.py``). The tool compiles the source twice into this
checkout's ``build/fused_chunk_split/``:

- as it stands, for the chunk's time (median of ``reps`` CUDA-event
  timings);
- with a timer at each ``grid.sync();`` and each ``cluster.sync();``:
  thread 0 of every block reads ``%globaltimer`` (32 ns ticks) as its
  block arrives at the barrier and as it leaves. Per barrier, the work
  before it is the last arrival minus the previous release (the critical
  path), and the release is the first exit minus the last arrival, over
  the blocks the barrier joins: the grid, or one cluster. Works are
  summed by the barrier's line in the source. On the per-lane path each
  cluster passes its own barriers; the row gives the cluster whose
  barriers span the longest, and the barrier counts of all.

Both copies must give the state of this checkout's kernel (through
``ops.fused_run_*_phases``), which the tool checks. A chunk that passes
more than ``MAX_BARRIERS`` barriers, or a grid of more than
``MAX_BLOCKS`` blocks, is an error, not a shorter record. An empty
cooperative kernel of the same grid (on the per-lane path: a kernel of
the same clusters) gives the cost of one bare barrier.
Prints one JSON line per chunk. Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MAX_BARRIERS = 4096
MAX_BLOCKS = 2048

# defined ahead of the source; "#line 1" keeps its line numbers
_PRELUDE = r'''
__device__ unsigned long long *split_arr, *split_exit;
__device__ int *split_line;
__device__ int split_max, split_grid, split_block;
__device__ int split_count[%(blocks)d];

__device__ __forceinline__ unsigned long long split_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}

// every block records each of its barriers: [barrier * grid + block]
#define SPLIT_SYNC_ON(group, line)                                        \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0 && split_count[blockIdx.x] < split_max)          \
      split_arr[(long long)split_count[blockIdx.x] * gridDim.x +          \
                blockIdx.x] = split_timer();                              \
    group.sync();                                                         \
    if (threadIdx.x == 0) {                                               \
      const int i_ = split_count[blockIdx.x]++;                           \
      if (i_ < split_max) {                                               \
        const long long at_ = (long long)i_ * gridDim.x + blockIdx.x;     \
        split_exit[at_] = split_timer();                                  \
        split_line[at_] = (line);                                         \
        if (blockIdx.x == 0) {                                            \
          split_grid = gridDim.x;                                         \
          split_block = blockDim.x;                                       \
        }                                                                 \
      }                                                                   \
    }                                                                     \
  } while (0)
#define SPLIT_SYNC(line) SPLIT_SYNC_ON(grid, line)
#define SPLIT_CSYNC(line) SPLIT_SYNC_ON(cluster, line)
#line 1
'''

_EPILOGUE = r'''
__global__ void split_empty(int reps, unsigned long long *t) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  if (threadIdx.x == 0 && blockIdx.x == 0) t[0] = split_timer();
  for (int i = 0; i < reps; ++i) grid.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) t[1] = split_timer();
}

__global__ void split_empty_cluster(int reps, unsigned long long *t) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (threadIdx.x == 0 && blockIdx.x == 0) t[0] = split_timer();
  for (int i = 0; i < reps; ++i) cluster.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) t[1] = split_timer();
}

extern "C" int split_setup(void *arr, void *ex, void *line, int max) {
  void *cnt = nullptr;
  cudaError_t e = cudaMemcpyToSymbol(split_arr, &arr, sizeof arr);
  if (!e) e = cudaMemcpyToSymbol(split_exit, &ex, sizeof ex);
  if (!e) e = cudaMemcpyToSymbol(split_line, &line, sizeof line);
  if (!e) e = cudaMemcpyToSymbol(split_max, &max, sizeof max);
  if (!e) e = cudaGetSymbolAddress(&cnt, split_count);
  if (!e) e = cudaMemset(cnt, 0, sizeof split_count);
  return (int)e;
}

// the barriers each of the first `blocks` blocks passed
extern "C" int split_counts(int *out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, split_count, sizeof(int) * blocks);
}

// barriers passed by block 0, the grid and the block size of the launch
extern "C" int split_result(int *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, split_count, sizeof(int));
  if (!e) e = cudaMemcpyFromSymbol(out + 1, split_grid, sizeof(int));
  if (!e) e = cudaMemcpyFromSymbol(out + 2, split_block, sizeof(int));
  return (int)e;
}

// cluster 0 takes the grid barrier's kernel; C > 0 an empty kernel of
// clusters of C blocks
extern "C" int split_empty_launch(int grid, int block, int reps, void *t,
                                  int cluster) {
  cudaError_t e;
  if (cluster > 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(block);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    unsigned long long *tt = static_cast<unsigned long long *>(t);
    e = cudaLaunchKernelEx(&cfg, split_empty_cluster, reps, tt);
  } else {
    void *args[] = {&reps, &t};
    e = cudaLaunchCooperativeKernel((void *)split_empty, dim3(grid),
                                    dim3(block), args, 0, 0);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}
'''


def instrument(src: str) -> str:
    """``src`` with every ``grid.sync();`` and ``cluster.sync();`` timed;
    line numbers kept."""
    body, sites = re.subn(r"\bgrid\.sync\(\);", "SPLIT_SYNC(__LINE__);",
                          src)
    if not sites:
        raise RuntimeError("fused_chunk_split: no grid.sync(); in the source")
    body = re.sub(r"\bcluster\.sync\(\);", "SPLIT_CSYNC(__LINE__);", body)
    return _PRELUDE % {"blocks": MAX_BLOCKS} + body + _EPILOGUE


# --kernel -> (kernel name in ops, default source)
KERNELS = {"assignment": ("fused_assignment_phases", "fused_assignment.cu"),
           "ot": ("fused_ot_phases", "fused_ot.cu")}


def build(source: Path, ops, name: str):
    """Compiles ``source`` (the kernel ``name`` of ``ops``) as it stands
    and instrumented, in parallel; returns the two loaded libraries
    (plain, timed)."""
    out = ROOT / "build" / "fused_chunk_split"
    out.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((ops.source_digest(source) + _PRELUDE
                             + _EPILOGUE).encode()).hexdigest()[:16]
    timed_cu = out / f"timed-{digest}.cu"
    timed_cu.write_text(instrument(source.read_text()))
    jobs = [(source, out / f"libplain-{digest}.so"),
            (timed_cu, out / f"libtimed-{digest}.so")]
    procs = [subprocess.Popen(
        [ops._nvcc(), *ops.NVCC_FLAGS, "-I", str(source.parent), "-o",
         str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for cu, so in jobs if not so.exists()]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log}")
    libs = []
    _, fn_name, argtypes = ops._ENTRY[name]
    for _, so in jobs:
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn_name).argtypes = argtypes
        ws = getattr(lib, ops._WORKSPACE[name])
        ws.argtypes = [ctypes.c_int] * 3
        ws.restype = ctypes.c_longlong
        libs.append(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs[1].split_setup.argtypes = [p, p, p, i]
    libs[1].split_result.argtypes = [p]
    libs[1].split_counts.argtypes = [p, i]
    libs[1].split_empty_launch.argtypes = [i, i, i, p, i]
    return libs


def launcher(torch, lib, c_int, s0, thr, cap, mv, k, cluster=0):
    """``fused_assignment_launch`` of ``lib`` on one chunk, as
    ``ops.fused_run_assignment_phases`` calls it on the grid path
    (``cluster`` 0) or the per-lane path in clusters of ``cluster``
    blocks; returns a function that runs it and returns the state out."""
    b, m, n = c_int.shape
    ws = torch.empty(int(lib.fused_assignment_workspace(b, m, n)),
                     dtype=torch.uint8, device=c_int.device)
    vec = int(n % 4 == 0 and c_int.data_ptr() % 16 == 0)

    def run():
        out = [torch.empty_like(t) for t in s0]
        err = lib.fused_assignment_launch(
            c_int.data_ptr(), *(t.data_ptr() for t in s0), thr.data_ptr(),
            cap.data_ptr(), mv.data_ptr(), *(t.data_ptr() for t in out),
            ws.data_ptr(), b, m, n, k, vec, cluster,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_assignment_launch failed ({err})")
        return type(s0)(*out)
    return run


def ot_launcher(torch, lib, c_int, s0, thr, cap, mr, k, cluster=0):
    """``fused_ot_launch`` of ``lib`` on one chunk, as
    ``ops.fused_run_ot_phases`` calls it; returns a function that runs
    it and returns the state out."""
    b, nb, na = c_int.shape
    ws = torch.empty(int(lib.fused_ot_workspace(b, nb, na)),
                     dtype=torch.uint8, device=c_int.device)
    vec = int(na % 4 == 0 and c_int.data_ptr() % 16 == 0)

    def run():
        out = [torch.empty_like(t) for t in s0]
        err = lib.fused_ot_launch(
            c_int.data_ptr(), *(t.data_ptr() for t in s0), thr.data_ptr(),
            cap.data_ptr(), *(t.data_ptr() for t in out), ws.data_ptr(), b,
            nb, na, k, mr, vec, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_ot_launch failed ({err})")
        return type(s0)(*out)
    return run


def _group_split(arr, ext, tags):
    """The split of one barrier group (the grid, or one cluster): arrays
    (barriers, blocks) of arrival and exit ticks and the lines."""
    last_in, first_out = arr.max(1), ext.min(1)
    prev = np.concatenate([[arr[0].min()], first_out[:-1]])
    work, mean_work = last_in - prev, arr.mean(1) - prev
    by_line = {}
    for line in sorted(set(tags.tolist())):
        sel = tags == line
        by_line[f"line {line}"] = {
            "barriers": int(sel.sum()),
            "critical_us": float(work[sel].sum() / 1e3),
            "mean_block_us": float(mean_work[sel].sum() / 1e3)}
    return {"barriers": int(len(tags)),
            "span_us": float((ext.max() - arr.min()) / 1e3),
            "release_us": float((first_out - last_in).sum() / 1e3),
            "by_line": by_line}


def split(torch, lib, run, dev, cluster=0):
    """The per-line split of one instrumented run (the median of 7 by
    span) and the cost of a bare barrier on the same grid. With
    ``cluster`` > 0 (the per-lane path) each cluster of that many blocks
    is split on its own, and the cluster that spans the longest is
    given, with every cluster's barrier count."""
    t_arr = torch.zeros(MAX_BARRIERS * MAX_BLOCKS, dtype=torch.int64,
                        device=dev)
    t_exit = torch.zeros_like(t_arr)
    lines = torch.zeros(MAX_BARRIERS * MAX_BLOCKS, dtype=torch.int32,
                        device=dev)
    res = (ctypes.c_int * 3)()
    runs = []
    for _ in range(7):
        torch.cuda.synchronize()
        if lib.split_setup(t_arr.data_ptr(), t_exit.data_ptr(),
                           lines.data_ptr(), MAX_BARRIERS):
            raise RuntimeError("split_setup failed")
        run()
        torch.cuda.synchronize()
        if lib.split_result(res):
            raise RuntimeError("split_result failed")
        _, g, block = res
        if g > MAX_BLOCKS:
            raise RuntimeError(f"fused_chunk_split: a grid of {g} blocks; "
                               f"the record holds {MAX_BLOCKS}")
        # every block's barrier count
        counts = (ctypes.c_int * g)()
        if lib.split_counts(counts, g):
            raise RuntimeError("split_counts failed")
        per_block = np.frombuffer(counts, dtype=np.int32).copy()
        if per_block.max() > MAX_BARRIERS:
            raise RuntimeError(
                f"fused_chunk_split: a block passed {per_block.max()} "
                f"barriers; the record holds {MAX_BARRIERS} (raise "
                f"MAX_BARRIERS)")
        nmax = int(per_block.max())
        arr = t_arr[:nmax * g].view(nmax, g).cpu().numpy()
        ext = t_exit[:nmax * g].view(nmax, g).cpu().numpy()
        tags = lines[:nmax * g].view(nmax, g).cpu().numpy()
        size = cluster or g
        groups = []
        for q in range(g // size):
            cols = slice(q * size, (q + 1) * size)
            nq = int(per_block[q * size])
            if nq:
                groups.append(_group_split(arr[:nq, cols], ext[:nq, cols],
                                           tags[:nq, q * size]))
        row = max(groups, key=lambda x: x["span_us"])
        row.update(grid=g, block=block)
        if cluster:
            row["cluster"] = cluster
            row["barriers_by_cluster"] = [x["barriers"] for x in groups]
        runs.append(row)
    # the buffers go with this call: later runs of the copy record nothing
    if lib.split_setup(None, None, None, 0):
        raise RuntimeError("split_setup failed")
    runs.sort(key=lambda r: r["span_us"])
    best = runs[len(runs) // 2]
    t = torch.zeros(2, dtype=torch.int64, device=dev)
    if lib.split_empty_launch(best["grid"], best["block"], 1000,
                              t.data_ptr(), cluster):
        raise RuntimeError("empty barrier launch failed")
    best["bare_barrier_us"] = float((t[1] - t[0]).item() / 1e3 / 1000)
    return best


def chunks(torch, cs, ops, kernel, seed, dev):
    """(name, chunk maker, launcher, the state of this checkout's kernel)
    for each of chip_smoke's chunks of ``kernel``."""
    k = cs.SIZES["fused_k"]
    if kernel == "assignment":
        fig1_rng = cs.fig1_generator(seed)

        def want(c_int, s0, thr, cap, mv):
            return ops.fused_run_assignment_phases(c_int, s0, thr, cap, k,
                                                   m_valid=mv)
        return [("B=16, 1024^2, 3 stepped phases in",
                 lambda: cs.fused_assignment_chunk(
                     torch, np.random.default_rng([seed, 2]), dev),
                 launcher, want),
                ("B=1, 10000^2, from phase 280",
                 lambda: cs.fused_assignment_full_chunk(torch, ops, fig1_rng,
                                                        dev),
                 launcher, want)]

    def want(c_int, s0, thr, cap, mr):
        return ops.fused_run_ot_phases(c_int, s0, thr, cap, k, mr)

    def b8():
        # chip_smoke draws the assignment chunk from this generator first
        rng = np.random.default_rng([seed, 2])
        cs.fused_assignment_chunk(torch, rng, dev)
        torch.cuda.empty_cache()
        return cs.fused_ot_chunk(torch, rng, dev)
    return [("B=8, 512^2, 2 stepped phases in", b8, ot_launcher, want),
            ("B=1, 4096^2, from the initial state",
             lambda: cs.fused_ot_full_chunk(torch, seed, dev), ot_launcher,
             want)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS),
                    default="assignment")
    ap.add_argument("--source", default="",
                    help="the kernel's .cu (default: this checkout's)")
    ap.add_argument("--path", choices=("grid", "lane", "both"),
                    default="both")
    ap.add_argument("--cluster", type=int, default=0,
                    choices=(0, 1, 2, 4, 8),
                    help="blocks a cluster on the per-lane path (default: "
                         "the route's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    name, default_cu = KERNELS[args.kernel]
    source = Path(args.source or ROOT / "src" / "repro_torch" / "csrc"
                  / default_cu).resolve()
    import torch
    if not torch.cuda.is_available():
        print("fused_chunk_split: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    k = cs.SIZES["fused_k"]
    ops.build_kernels()
    plain, timed = build(source, ops, name)
    paths = ["grid"]        # the OT kernel's only path
    if args.kernel == "assignment":
        paths = ["grid", "lane"] if args.path == "both" else [args.path]
    rows = []
    for chunk, make, launch, want_of in chunks(torch, cs, ops, args.kernel,
                                               args.seed, dev):
        c_int, s0, thr, cap, extra = make()
        s0 = type(s0)(*(t.contiguous() for t in s0))
        want = want_of(c_int, s0, thr, cap, extra)
        for path in paths:
            cluster = 0
            if path == "lane":
                b, m, n = c_int.shape
                r = ops.fused_assignment_route(b, m, n, ops._sm_count(dev))
                cluster = args.cluster or r.cluster or 8
            run = launch(torch, plain, c_int, s0, thr, cap, extra, k,
                         cluster)
            run_timed = launch(torch, timed, c_int, s0, thr, cap, extra, k,
                               cluster)
            same = [all(torch.equal(x, y) for x, y in zip(f(), want))
                    for f in (run, run_timed)]
            ms = cs.cuda_ms(torch, run, reps=args.reps)
            rounds = (want.rounds - s0.rounds).tolist()
            row = {"kernel": name, "chunk": chunk, "path": path,
                   "cluster": cluster, "source": str(source), "ms": ms,
                   "phases": (want.phases - s0.phases).tolist(),
                   "rounds": rounds,
                   "ms_per_round": ms / max(max(rounds), 1),
                   "same_state_as_kernel": same,
                   "split": split(torch, timed, run_timed, dev, cluster)}
            if args.kernel == "assignment":
                row["free_rows_before"] = int((s0.match_ba < 0).sum())
            else:
                row["free_rows_before"] = int((s0.free_b > 0).sum())
            print(json.dumps(row), flush=True)
            rows.append(row)
        del c_int, s0, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": cs.smi_line(), "rows": rows}, indent=1))
    print(cs.smi_line())
    return 0 if all(all(r["same_state_as_kernel"]) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
