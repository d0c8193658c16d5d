"""Where a block of the flash-attention backward kernels spends its time, on
one NVIDIA card.

    python3 chip_bwd_phases.py

Builds an instrumented copy of ``paddle_tpu_torch/csrc/flash_attn_bwd.cu``
(into the gitignored ``paddle_tpu_torch/_build/``): thread 0 of block (0, 0)
writes ``clock64()`` at each phase boundary of the dQ and dK/dV kernels,
each stamp after the registers of its phase are ready. Then it runs both
kernels through the port's wrappers at (1, 1, 128, 64), one block alone,
and at (8, 12, 128, 64), the training path's shape, in f32 and bf16, and
prints the cycles of each phase: the prologue (owned tiles and the first
inner tile arrive), then per inner tile the two A·Bᵀ products, the
per-score work, the P·B products and the closing barrier. Needs a CUDA
card and exits non-zero without one. The copy is made by string edits that
assert they match, so a change to the kernel's loop shape fails here
loudly rather than stamping the wrong place.
"""
import ctypes
import os
import subprocess
import sys

import torch

STAMPS = 64     # dQ stamps at 0.., dK/dV at 32..


def instrumented_source(src):
    def rep(s, old, new, count=1):
        if s.count(old) != count:
            raise SystemExit("chip_bwd_phases: %r found %d times, want %d" % (
                old[:60], s.count(old), count))
        return s.replace(old, new)

    s = rep(src, "namespace {\n\nconstexpr int kRows", (
        "__device__ long long g_clk[%d];\n"
        "#define STAMP(i, dep) do { asm volatile(\"\" :: \"f\"(dep)); \\\n"
        "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) "
        "g_clk[(i)] = clock64(); } while (0)\n"
        "namespace {\n\nconstexpr int kRows") % STAMPS)
    s = rep(s, "  const int bh = blockIdx.y;\n",
            "  const int bh = blockIdx.y;\n  const int base = KBASE;\n", 2)
    dq, dkdv = s.split("const int base = KBASE;")[1:]
    s = (s.split("const int base = KBASE;")[0] + "const int base = 0;" + dq
         + "const int base = 32;" + dkdv)
    s = rep(s, "  const uint32_t seed_bh = fold_bh_seed(seed, bh);\n",
            "  const uint32_t seed_bh = fold_bh_seed(seed, bh);\n"
            "  STAMP(base, 0.f);\n", 2)
    for owned in ("kt", "qt"):
        s = rep(s, "    __syncthreads();\n    const T* %s = " % owned,
                "    __syncthreads();\n    STAMP(base + 1 + 6 * it, 0.f);\n"
                "    const T* %s = " % owned)
    for a in ("dos + 16 * warp * kLd, vt", "vs + 16 * warp * kLd, dot"):
        line = "    mma_abt<kBc / 8, DP>(dp, %s, lane);\n" % a
        s = rep(s, line, line + "    STAMP(base + 2 + 6 * it, dp[kBc / 8 - 1][3]"
                " + s[kBc / 8 - 1][3]);\n")
    s = rep(s, "    mma_pb<kBc / 8, DP>(acc, s, kt, lane);\n",
            "    STAMP(base + 3 + 6 * it, s[kBc / 8 - 1][3]);\n"
            "    mma_pb<kBc / 8, DP>(acc, s, kt, lane);\n"
            "    STAMP(base + 4 + 6 * it, acc[DP / 8 - 1][3]);\n")
    s = rep(s, "    mma_pb<kBc / 8, DP>(dv_acc, s, dot, lane);\n"
               "    mma_pb<kBc / 8, DP>(dk_acc, dp, qt, lane);\n",
            "    STAMP(base + 3 + 6 * it, s[kBc / 8 - 1][3] + dp[kBc / 8 - 1][3]);\n"
            "    mma_pb<kBc / 8, DP>(dv_acc, s, dot, lane);\n"
            "    mma_pb<kBc / 8, DP>(dk_acc, dp, qt, lane);\n"
            "    STAMP(base + 4 + 6 * it, dk_acc[DP / 8 - 1][3]"
            " + dv_acc[DP / 8 - 1][3]);\n")
    s = rep(s, "    __syncthreads();  // every warp is done with this buffer "
               "before it is refilled\n  }\n",
            "    __syncthreads();  // every warp is done with this buffer "
            "before it is refilled\n    STAMP(base + 5 + 6 * it, 0.f);\n  }\n", 2)
    return s + (
        "\nextern \"C\" int phases_read(long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n"
        "extern \"C\" int phases_clear() {\n  long long z[%d] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n}\n" % STAMPS)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a CUDA card")
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_build

    src = os.path.join(cuda_build.CSRC_DIR, "flash_attn_bwd.cu")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, "flash_attn_bwd_phases.cu")
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
    cuda_build.build_all(("flash_attn_fwd",))
    real_load = cuda_build.load
    cuda_build.load = lambda n: lib if n == "flash_attn_bwd" else real_load(n)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    buf = (ctypes.c_longlong * STAMPS)()
    print("cycles of block (0, 0), thread 0: prologue | per inner tile: "
          "A·Bᵀ products, per-score work, P·B products, barrier | total")
    for dt in (torch.float32, torch.bfloat16):
        for b, h in ((1, 1), (8, 12)):
            q, k, v, do = (torch.randn(b, h, 128, 64, generator=gen,
                                       device="cuda").to(dt) for _ in range(4))
            out, lse = ca.flash_attention(q, k, v)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, None, None, do, lse, delta)
            for name, fn, base in (("dQ", ca.flash_attention_dq, 0),
                                   ("dK/dV", ca.flash_attention_dkdv, 32)):
                for _ in range(3):
                    fn(*args)
                torch.cuda.synchronize()
                lib.phases_clear()
                fn(*args)
                torch.cuda.synchronize()
                lib.phases_read(ctypes.addressof(buf))
                st = [buf[base + i] for i in range(32)]
                tiles, end = [], st[0]
                for it in range(5):
                    t = st[1 + 6 * it:6 + 6 * it]
                    if not all(t):
                        break
                    tiles.append("%d/%d/%d/%d" % (t[1] - t[0], t[2] - t[1],
                                                  t[3] - t[2], t[4] - t[3]))
                    end = t[4]
                print("%-8s %-12s %-5s prologue %6d | %s | total %d" % (
                    str(dt)[6:], "(%d,%d,128,64)" % (b, h), name,
                    st[1] - st[0], " ".join(tiles), end - st[0]), flush=True)


if __name__ == "__main__":
    main()
