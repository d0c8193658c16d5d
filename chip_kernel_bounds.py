"""Out-of-bounds check of the port's hand-written CUDA kernels on the card.

Every buffer a kernel reads or writes (inputs, outputs, the LayerNorm
backward's scratch) is placed flush against an unmapped guard region of
device address space: first each buffer ends where the mapping ends, then
each begins where it begins. A read or write past either end of any buffer
then faults at once (``an illegal memory access``) instead of landing,
unnoticed, in a neighbouring allocation of the caching allocator. The guard
buffers come from the driver's virtual memory calls (cuMemAddressReserve,
cuMemCreate, cuMemMap) through ctypes, and reach the wrappers as torch
tensors through ``__cuda_array_interface__``; the wrappers' own
``torch.empty``/``torch.empty_like`` calls are routed to them while a
kernel runs. Each result is also held against the kernel's plain version.

    python3 chip_kernel_bounds.py        # needs a CUDA card and nvcc
    python3 chip_kernel_bounds.py --hammer 3000 [seed]

The second runs :func:`hammer` instead: LayerNorm launches at random
shapes on the caching allocator's ordinary buffers, which is how the
read past bfloat16 gamma's end showed outside this check (a fault in a
few hundred to a few thousand launches).

Prints one line per case and exits 0 when every case ran inside its
buffers and agreed; a fault raises an error that names its case.
chip_smoke.py runs :func:`check_all` in its phase 3.
"""
import ctypes
import math
import os
import sys

import torch

SEED = 0


class _Loc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Prop(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Loc), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _Access(ctypes.Structure):
    _fields_ = [("location", _Loc), ("flags", ctypes.c_int)]


class GuardedMemory:
    """Device buffers, each inside a mapping with unmapped address space on
    both sides. ``at_end``: a buffer ends where its mapping ends (else it
    begins where its mapping begins)."""

    def __init__(self, device=0):
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.prop = _Prop()
        self.prop.type = 1                # CU_MEM_ALLOCATION_TYPE_PINNED
        self.prop.location.type = 1       # CU_MEM_LOCATION_TYPE_DEVICE
        self.prop.location.id = device
        gran = ctypes.c_size_t(0)
        self._ok(self.cu.cuMemGetAllocationGranularity(
            ctypes.byref(gran), ctypes.byref(self.prop), 0),
            "cuMemGetAllocationGranularity")
        self.gran = gran.value
        self.access = _Access()
        self.access.location.type = 1
        self.access.location.id = device
        self.access.flags = 3             # CU_MEM_ACCESS_FLAGS_PROT_READWRITE
        self.live = []
        self.at_end = True

    @staticmethod
    def _ok(rc, what):
        if rc != 0:
            raise RuntimeError("%s failed: CUresult %d" % (what, rc))

    def tensor(self, shape, dtype):
        shape = tuple(int(s) for s in shape)
        el = torch.tensor([], dtype=dtype).element_size()
        nbytes = max(1, math.prod(shape)) * el
        mapped = -(-nbytes // self.gran) * self.gran
        span = mapped + 2 * self.gran
        base = ctypes.c_uint64(0)
        self._ok(self.cu.cuMemAddressReserve(
            ctypes.byref(base), ctypes.c_size_t(span),
            ctypes.c_size_t(self.gran), ctypes.c_uint64(0),
            ctypes.c_ulonglong(0)), "cuMemAddressReserve")
        handle = ctypes.c_uint64(0)
        self._ok(self.cu.cuMemCreate(ctypes.byref(handle), ctypes.c_size_t(
            mapped), ctypes.byref(self.prop), ctypes.c_ulonglong(0)),
            "cuMemCreate")
        start = base.value + self.gran
        self._ok(self.cu.cuMemMap(ctypes.c_uint64(start), ctypes.c_size_t(
            mapped), ctypes.c_size_t(0), handle, ctypes.c_ulonglong(0)),
            "cuMemMap")
        self._ok(self.cu.cuMemSetAccess(ctypes.c_uint64(start),
                                        ctypes.c_size_t(mapped),
                                        ctypes.byref(self.access),
                                        ctypes.c_size_t(1)), "cuMemSetAccess")
        self.live.append((base.value, span, start, mapped, handle))
        ptr = start + mapped - nbytes if self.at_end else start
        # __cuda_array_interface__ has no bfloat16: take its bits as int16
        view = {torch.float32: ("<f4", None), torch.int64: ("<i8", None),
                torch.int32: ("<i4", None), torch.bool: ("|b1", None),
                torch.bfloat16: ("<i2", torch.bfloat16),
                torch.float16: ("<f2", None)}[dtype]

        class _Cai:
            __cuda_array_interface__ = {"shape": shape, "typestr": view[0],
                                        "data": (ptr, False), "version": 2,
                                        "strides": None}

        t = torch.as_tensor(_Cai(), device="cuda")
        return t.view(view[1]) if view[1] is not None else t

    def free_all(self):
        torch.cuda.synchronize()
        for base, span, start, mapped, handle in self.live:
            self._ok(self.cu.cuMemUnmap(ctypes.c_uint64(start),
                                        ctypes.c_size_t(mapped)), "cuMemUnmap")
            self._ok(self.cu.cuMemRelease(handle), "cuMemRelease")
            self._ok(self.cu.cuMemAddressFree(ctypes.c_uint64(base),
                                              ctypes.c_size_t(span)),
                     "cuMemAddressFree")
        self.live = []


class Routed:
    """While active, torch.empty/torch.empty_like on the card return
    guarded buffers: the kernels' outputs and scratch are guarded too."""

    def __init__(self, mem):
        self.mem = mem

    def __enter__(self):
        self.empty, self.empty_like = torch.empty, torch.empty_like
        mem, empty, empty_like = self.mem, self.empty, self.empty_like

        def g_empty(*size, dtype=None, device=None, **kw):
            if len(size) == 1 and isinstance(size[0], (tuple, list,
                                                       torch.Size)):
                size = tuple(size[0])
            if device is None or torch.device(device).type != "cuda":
                return empty(size, dtype=dtype, device=device, **kw)
            return mem.tensor(size, dtype or torch.float32)

        def g_empty_like(t, dtype=None, **kw):
            if not t.is_cuda:
                return empty_like(t, dtype=dtype, **kw)
            return mem.tensor(t.shape, dtype or t.dtype)

        torch.empty, torch.empty_like = g_empty, g_empty_like
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like = self.empty, self.empty_like
        return False


def guarded_copy(mem, t):
    if t is None:
        return None
    g = mem.tensor(t.shape, t.dtype)
    g.copy_(t)
    return g


def rel_err(a, ref):
    """max|a - ref| over max(1, max|ref|)."""
    if not a.numel():
        return 0.0
    return ((a.float() - ref.float()).abs().max().item()
            / max(1.0, ref.float().abs().max().item()))


def ln_cases():
    # the rows and widths the main path gives the LayerNorm kernels
    # (serving buckets, the GPT decode step, training at 8 x 128, the NMT
    # width), widths that take one element per load (770, 100), rows too
    # long for registers (4096) and for shared memory (30000: the
    # partials go to scratch), and every pairing of x's and gamma's dtypes
    shapes = [(1024, 768), (8, 768), (64, 768), (128, 768), (256, 768),
              (512, 768), (1000, 768), (128, 512), (1024, 512), (1, 768),
              (1024, 770), (1000, 100), (8192, 1024), (256, 4096),
              (4, 30000)]
    pairs = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
             (torch.float32, None)]
    for n, h in shapes:
        for xd, wd in pairs:
            yield n, h, xd, wd


def attn_cases():
    # (label, B, Tq, Tk, D, options): chip_smoke's phase 3 cases, a decode
    # step's one query over a masked cache, and a longer causal row
    return [("plain", 8, 128, 128, 64, {}), ("B=1", 1, 128, 128, 64, {}),
            ("B=16", 16, 128, 128, 64, {}),
            ("causal", 8, 128, 128, 64, dict(causal=True)),
            ("kpm", 8, 128, 128, 64, dict(kpm=True)),
            ("T=131", 8, 131, 131, 64, dict(kpm=True, causal=True)),
            ("dropout", 8, 128, 128, 64, dict(dropout_p=0.1, seed=7)),
            ("D=128", 8, 128, 128, 128, {}), ("D=40", 8, 128, 128, 40, {}),
            ("Tq=128 Tk=96 kpm", 8, 128, 96, 64, dict(kpm=True)),
            ("decode Tq=1 Tk=77", 8, 1, 77, 64, dict(kpm=True)),
            ("T=512", 2, 512, 512, 64, dict(causal=True))]


def run_ln(mem, cl, gen, n, h, xd, wd):
    x = torch.randn(n, h, generator=gen, device="cuda").to(xd)
    dy = torch.randn(n, h, generator=gen, device="cuda").to(xd)
    g = b = None
    if wd is not None:
        g = torch.randn(h, generator=gen, device="cuda").to(wd)
        b = torch.randn(h, generator=gen, device="cuda").to(wd)
    y0, m0, r0 = cl.layer_norm_plain(x, g, b, 1e-5)
    gx, gg, gb, gdy = (guarded_copy(mem, t) for t in (x, g, b, dy))
    with Routed(mem):
        y, mean, rstd = cl.layer_norm_fwd(gx, gg, gb, 1e-5)
        torch.cuda.synchronize()
        dx, dg, db = cl.layer_norm_bwd(gx, gg, mean, rstd, gdy)
        torch.cuda.synchronize()
    ref = cl.layer_norm_bwd_plain(x, g, m0, r0, dy)
    return max(rel_err(a, r) for a, r in zip(
        (y, mean, rstd, dx, dg, db), (y0, m0, r0) + tuple(ref)))


def run_attn(mem, ca, gen, b, tq, tk, d, kw, dt):
    kw = dict(kw)
    rnd = (lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt))
    q, do = rnd(b, 12, tq, d), rnd(b, 12, tq, d)
    k, v = rnd(b, 12, tk, d), rnd(b, 12, tk, d)
    kpm = None
    if kw.pop("kpm", False):
        kpm = torch.where(torch.rand(b, tk, generator=gen, device="cuda")
                          < 0.2, -1e30, 0.0)
        kpm[:, 0] = 0.0
    ref, ref_lse = ca.flash_attention_plain(q, k, v, kpm, **kw)
    delta = (do.float() * ref.float()).sum(-1)
    gq, gk, gv, gdo, gkpm, glse, gdelta = (
        guarded_copy(mem, t) for t in (q, k, v, do, kpm, ref_lse, delta))
    with Routed(mem):
        out, lse = ca.flash_attention(gq, gk, gv, gkpm, **kw)
        torch.cuda.synchronize()
        args = (gq, gk, gv, gkpm, kw.get("seed"), gdo, glse, gdelta)
        opts = {k2: kw[k2] for k2 in ("causal", "dropout_p") if k2 in kw}
        dq = ca.flash_attention_dq(*args, **opts)
        torch.cuda.synchronize()
        dk, dv, _ = ca.flash_attention_dkdv(*args, **opts)
        torch.cuda.synchronize()
    plain_args = (q, k, v, kpm, kw.get("seed"), do, ref_lse, delta)
    rq = ca.flash_attention_dq_plain(*plain_args, **opts)
    rk, rv, _ = ca.flash_attention_dkdv_plain(*plain_args, **opts)
    return max(rel_err(a, r)
               for a, r in ((out, ref), (dq, rq), (dk, rk), (dv, rv)))


def check_all(ca, cl, log=None):
    """Every case, flush at the end of its buffers and then at the start.
    Returns (cases run, [(label, error)] of the cases that disagree with
    the plain version); a fault raises, naming its case. `log(line)`, if
    given, gets a line a case."""
    torch.zeros(1, device="cuda")
    mem = GuardedMemory()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # each output against its plain version on the same inputs, relative
    # to the plain output's largest magnitude (at least 1): 1e-3 in f32,
    # 2^-5 (a few bfloat16 roundings) where any value is bfloat16
    bound = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -5}
    cases = []
    for side in ("end", "start"):
        for n, h, xd, wd in ln_cases():
            dt = torch.bfloat16 if torch.bfloat16 in (xd, wd) \
                else torch.float32
            cases.append((
                "layer_norm (%d, %d) x %s gamma %s, flush at the %s" % (
                    n, h, str(xd)[6:], str(wd)[6:] if wd else None, side),
                side, dt, lambda n=n, h=h, xd=xd, wd=wd: run_ln(
                    mem, cl, gen, n, h, xd, wd)))
        for label, b, tq, tk, d, kw in attn_cases():
            for dt in (torch.float32, torch.bfloat16):
                cases.append((
                    "flash attention %s %s, flush at the %s" % (
                        label, str(dt)[6:], side), side, dt,
                    lambda b=b, tq=tq, tk=tk, d=d, kw=kw, dt=dt: run_attn(
                        mem, ca, gen, b, tq, tk, d, kw, dt)))
    bad = []
    for label, side, dt, run in cases:
        mem.at_end = side == "end"
        try:
            err = run()
            mem.free_all()
        except Exception as e:
            raise RuntimeError("chip_kernel_bounds, case %s: %s: %s" % (
                label, type(e).__name__, e)) from e
        if log is not None:
            log("%s: max error %.3e" % (label, err))
        if not err <= bound[dt]:
            bad.append((label, err))
    return len(cases), bad


def hammer(cl, launches, seed=SEED):
    """`launches` LayerNorm forward and backward pairs at (n, 768), n drawn
    from the main path's row counts, f32 and bf16 in turn, on the caching
    allocator's ordinary buffers (an allocation of random size held or
    freed between pairs moves them around); synchronized after every
    launch, so a fault raises naming its launch. Returns the seconds."""
    import time

    import numpy as np

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    held = []
    t0 = time.monotonic()
    for i in range(launches):
        dt = (torch.bfloat16, torch.float32)[i % 2]
        n = int(rng.choice([8, 64, 128, 256, 512, 1000, 1024]))
        held.append(torch.empty(int(rng.integers(1, 1 << 20)),
                                device="cuda"))
        if len(held) > 40:
            held.pop(int(rng.integers(0, len(held))))
        x, dy = (torch.randn(n, 768, generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        g, b = (torch.randn(768, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        label = "pair %d: (%d, 768) %s" % (i, n, str(dt)[6:])
        try:
            _, mean, rstd = cl.layer_norm_fwd(x, g, b, 1e-5)
            torch.cuda.synchronize()
            cl.layer_norm_bwd(x, g, mean, rstd, dy)
            torch.cuda.synchronize()
        except Exception as e:
            raise RuntimeError("chip_kernel_bounds hammer, %s: %s: %s" % (
                label, type(e).__name__, e)) from e
    return time.monotonic() - t0


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    if sys.argv[1:2] == ["--hammer"]:
        launches = int(sys.argv[2]) if len(sys.argv) > 2 else 3000
        secs = hammer(cl, launches,
                      int(sys.argv[3]) if len(sys.argv) > 3 else SEED)
        print("hammer: %d LayerNorm forward and backward pairs in %.1f s, "
              "no fault" % (launches, secs), flush=True)
        return
    n, bad = check_all(ca, cl, log=lambda line: print(line, flush=True))
    for label, err in bad:
        print("DISAGREES: %s: %.3e" % (label, err), flush=True)
    print("all %d cases ran inside their buffers; %d disagree" % (
        n, len(bad)), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
