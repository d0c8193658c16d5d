"""Where the LayerNorm forward kernel's time goes, on one NVIDIA card.

    python3 chip_ln_fwd_phases.py

Builds an instrumented copy of ``paddle_tpu_torch/csrc/layer_norm_fwd.cu``
(into the gitignored ``paddle_tpu_torch/_build/``): thread 0 of every block
writes ``%globaltimer`` (ns, one clock for the whole card) when the block
starts, when gamma and beta are staged, when its last row is written and,
after a barrier, when every warp of the block is done. It runs the kernel
through the port's wrapper at the serving buckets' rows (128·B, 768),
B = 1, 8, in f32 and bf16, and prints the phases as ns from the first
block's start beside the call's device time (CUDA events, stream
pre-filled, as chip_smoke.py times it), the device time of a one-element
``fill_``, and of an empty kernel of one warp and of 128 blocks of 256
threads launched from a library built the same way. Needs a CUDA card and
exits non-zero without one. The copy is made by string edits that assert
they match, so a change to the kernel's shape fails here loudly rather than
stamping the wrong place.
"""
import ctypes
import os
import statistics
import subprocess
import sys

import torch

SLOTS = 4          # stamps per block
MAX_BLOCKS = 1024
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def instrumented_source(src):
    def rep(s, old, new, count=1):
        if s.count(old) != count:
            raise SystemExit("chip_ln_fwd_phases: %r found %d times, want %d"
                             % (old[:60], s.count(old), count))
        return s.replace(old, new)

    s = rep(src, '#include "ln_rows.cuh"\n', (
        '#include "ln_rows.cuh"\n'
        "__device__ unsigned long long g_t[%d];\n"
        "#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t; "
        "asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t)); "
        "g_t[blockIdx.x * %d + (i)] = t; } } while (0)\n") % (
            SLOTS * MAX_BLOCKS, SLOTS))
    s = rep(s, "  const int warps = gridDim.x * (blockDim.x >> 5);\n",
            "  STAMP(0);\n  const int warps = gridDim.x * (blockDim.x >> 5);\n")
    s = rep(s, "      __syncthreads();\n    }\n    while (row < n) {",
            "      __syncthreads();\n    }\n    STAMP(1);\n    while (row < n) {")
    s = rep(s, "      if (row < n) load_row<T, V, CH>(x + (size_t)row * h, xv, "
               "xs, h, lane);\n    }\n",
            "      if (row < n) load_row<T, V, CH>(x + (size_t)row * h, xv, "
            "xs, h, lane);\n      STAMP(2);\n    }\n"
            "    __syncthreads();\n    STAMP(3);\n")
    return s + (
        "\nextern \"C\" int phases_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_t, sizeof(g_t));\n}\n"
        "extern \"C\" int phases_clear() {\n"
        "  static unsigned long long z[%d] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(g_t, z, sizeof(z));\n}\n"
        % (SLOTS * MAX_BLOCKS))


def build(cuda_build, name, source):
    path = os.path.join(cuda_build.BUILD_DIR, name + ".cu")
    lib_path = path[:-3] + ".so"
    with open(path, "w") as out:
        out.write(source)
    r = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                        "-I", cuda_build.CSRC_DIR, "-o", lib_path, path],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print("FAIL: nvcc refused %s:\n%s" % (name, r.stderr))
        sys.exit(1)
    return ctypes.CDLL(lib_path)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a CUDA card")
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import device_ms
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "layer_norm_fwd.cu")) as f:
        lib = build(cuda_build, "layer_norm_fwd_phases",
                    instrumented_source(f.read()))
    lib.phases_read.argtypes = [ctypes.c_void_p]
    empty = build(cuda_build, "empty_kernel", EMPTY_SOURCE).empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    real_load = cuda_build.load
    cuda_build.load = lambda n: lib if n == "layer_norm_fwd" else real_load(n)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device="cuda")
    print("device ms: one-element fill_ %.4f, empty kernel <<<1, 32>>> %.4f, "
          "<<<128, 256>>> %.4f" % (
              device_ms(lambda: one.fill_(1.0)),
              device_ms(lambda: empty(1, 32, stream)),
              device_ms(lambda: empty(128, 256, stream))), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    buf = (ctypes.c_ulonglong * (SLOTS * MAX_BLOCKS))()
    print("ns from the first block's start: last block start | gamma/beta "
          "staged median / last | last row written median / last | block "
          "done last  (blocks); device ms of the instrumented call")
    for dt in (torch.float32, torch.bfloat16):
        for n, h in ((128, 768), (1024, 768)):
            x = torch.randn(n, h, generator=gen, device="cuda").to(dt)
            g, b = (torch.randn(h, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            ms = device_ms(lambda: cl.layer_norm_fwd(x, g, b, 1e-5))
            for rep in range(3):
                torch.cuda.synchronize()
                lib.phases_clear()
                cl.layer_norm_fwd(x, g, b, 1e-5)
                torch.cuda.synchronize()
                lib.phases_read(ctypes.addressof(buf))
                st = [[buf[SLOTS * i + j] for j in range(SLOTS)]
                      for i in range(MAX_BLOCKS)]
                st = [row for row in st if row[0]]
                t0 = min(row[0] for row in st)

                def col(j):
                    return sorted(row[j] - t0 for row in st)

                print("%-8s (%d, %d) run %d: %d | %d / %d | %d / %d | %d  "
                      "(%d blocks); %.4f ms" % (
                          str(dt)[6:], n, h, rep, col(0)[-1],
                          statistics.median(col(1)), col(1)[-1],
                          statistics.median(col(2)), col(2)[-1], col(3)[-1],
                          len(st), ms), flush=True)


if __name__ == "__main__":
    main()
