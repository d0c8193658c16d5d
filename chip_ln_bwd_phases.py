"""Where the LayerNorm backward kernel's time goes, on one NVIDIA card.

    python3 chip_ln_bwd_phases.py

Builds an instrumented copy of ``paddle_tpu_torch/csrc/layer_norm_bwd.cu``
(into the gitignored ``paddle_tpu_torch/_build/``): thread 0 of every block
writes ``%globaltimer`` (ns, one clock for the whole card) when the block
starts, when its rows are done, when its partial row is written, when it is
past the grid barrier and when its slice of the column sums is written.
Then it runs the kernel through the port's wrapper at (1024, 768), the
training path's shape, and at (8192, 1024), in f32 and bf16, and prints the
phases as ns from the first block's start. Needs a CUDA card and exits
non-zero without one. The copy is made by string edits that assert they
match, so a change to the kernel's shape fails here loudly rather than
stamping the wrong place.
"""
import ctypes
import os
import statistics
import subprocess
import sys

import torch

SLOTS = 5          # stamps per block
MAX_BLOCKS = 1024


def instrumented_source(src):
    def rep(s, old, new, count=1):
        if s.count(old) != count:
            raise SystemExit("chip_ln_bwd_phases: %r found %d times, want %d"
                             % (old[:60], s.count(old), count))
        return s.replace(old, new)

    s = rep(src, '#include "ln_rows.cuh"\n', (
        '#include "ln_rows.cuh"\n'
        "__device__ unsigned long long g_t[%d];\n"
        "#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t; "
        "asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t)); "
        "g_t[blockIdx.x * %d + (i)] = t; } } while (0)\n") % (
            SLOTS * MAX_BLOCKS, SLOTS))
    s = rep(s, "  zero_owned<kV>(mine, h, lane);\n",
            "  STAMP(0);\n  zero_owned<kV>(mine, h, lane);\n")
    s = rep(s, "  __syncthreads();\n  if (smem_parts)\n",
            "  __syncthreads();\n  STAMP(1);\n  if (smem_parts)\n")
    s = rep(s, "  cg::this_grid().sync();\n",
            "  __syncthreads();\n  STAMP(2);\n  cg::this_grid().sync();\n"
            "  STAMP(3);\n")
    s = rep(s, "  sum_columns<W>(part, h, dg, db);\n",
            "  sum_columns<W>(part, h, dg, db);\n  STAMP(4);\n")
    return s + (
        "\nextern \"C\" int phases_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_t, sizeof(g_t));\n}\n"
        "extern \"C\" int phases_clear() {\n"
        "  static unsigned long long z[%d] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(g_t, z, sizeof(z));\n}\n"
        % (SLOTS * MAX_BLOCKS))


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a CUDA card")
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    src = os.path.join(cuda_build.CSRC_DIR, "layer_norm_bwd.cu")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, "layer_norm_bwd_phases.cu")
    lib_path = path[:-3] + ".so"
    with open(src) as f, open(path, "w") as out:
        out.write(instrumented_source(f.read()))
    r = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                        "-I", cuda_build.CSRC_DIR, "-o", lib_path, path],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print("FAIL: nvcc refused the instrumented copy:\n" + r.stderr)
        sys.exit(1)
    lib = ctypes.CDLL(lib_path)
    lib.phases_read.argtypes = [ctypes.c_void_p]
    cuda_build.build_all(("layer_norm_fwd",))
    real_load = cuda_build.load
    cuda_build.load = lambda n: lib if n == "layer_norm_bwd" else real_load(n)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    buf = (ctypes.c_ulonglong * (SLOTS * MAX_BLOCKS))()
    print("ns from the first block's start: last block start | rows done "
          "median / last | partial row written last | past the grid barrier "
          "first / last | column sums done last  (blocks)")
    for dt in (torch.float32, torch.bfloat16):
        for n, h in ((1024, 768), (8192, 1024)):
            x, dy = (torch.randn(n, h, generator=gen, device="cuda").to(dt)
                     for _ in range(2))
            g, b = (torch.randn(h, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            _, mean, rstd = cl.layer_norm_fwd(x, g, b, 1e-5)
            for _ in range(3):
                cl.layer_norm_bwd(x, g, mean, rstd, dy)
            for rep in range(3):
                torch.cuda.synchronize()
                lib.phases_clear()
                cl.layer_norm_bwd(x, g, mean, rstd, dy)
                torch.cuda.synchronize()
                lib.phases_read(ctypes.addressof(buf))
                st = [[buf[SLOTS * i + j] for j in range(SLOTS)]
                      for i in range(MAX_BLOCKS)]
                st = [row for row in st if row[0]]
                t0 = min(row[0] for row in st)

                def col(j):
                    return sorted(row[j] - t0 for row in st)

                print("%-8s (%d, %d) run %d: %d | %d / %d | %d | %d / %d | %d"
                      "  (%d blocks)" % (
                          str(dt)[6:], n, h, rep, col(0)[-1],
                          statistics.median(col(1)), col(1)[-1], col(2)[-1],
                          col(3)[0], col(3)[-1], col(4)[-1], len(st)),
                      flush=True)


if __name__ == "__main__":
    main()
