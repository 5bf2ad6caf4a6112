"""Where the kNN distance kernel's time goes, on one NVIDIA GPU.

    python3 profile_dist.py [--out chiprun_out/profile_dist.json]

Run from the repository root on a machine with a Hopper card. At the main
path's three distance shapes (chip_smoke.main_dist_shapes, f32, 512-slot
banks at L = 7; plus the 1024-row bucket client-major, to separate bank
reloads from routing) it prints one JSON line of:

  * stamps: copies of csrc/dist_tiles.cu and of its predecessor
    csrc/dist_tiles_baseline.cu built under build/profile_dist/ with
    clock64() stamps added (thread 0 of every CTA accumulates its cycles
    reading its rows' q and bank index (for the predecessor: staging its
    tile), in bank loads and in all, into __device__ counters): the mean
    per CTA, and the CTA count, of one launch;
  * hints: the device time (torch.profiler) of the kernel with plain and
    with evict-first output stores (a copy whose entry takes either), alone
    and as the kNN score's first launch (routed_kth_distance's mask, top-k
    and gather after it, exact top-k), beside the predecessor's time in the
    same process.

A stamped copy is a diagnostic: its clock reads cost time, so only the
split between phases is read from it, never a speed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (anchor, replacement) edits that add stamps; each anchor must be found
STAMP_HEAD = """
__device__ unsigned long long g_stamp[4];
"""
STAMP_TAKE = """
extern "C" int stamps_take(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""
STAMP_WRITE = """
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(&g_stamp[0], static_cast<unsigned long long>(t_stage));
    atomicAdd(&g_stamp[1], static_cast<unsigned long long>(t_bank));
    atomicAdd(&g_stamp[2],
              static_cast<unsigned long long>(clock64() - t_begin));
    atomicAdd(&g_stamp[3], 1ULL);
  }
"""

LOAD_BANK = ("              load_bank<LC>(a, g, wg0, lane, valid, stage, bv, "
             "bn);\n")
STAMPS = {
    "dist_tiles": [
        ("namespace {\n", "namespace {\n" + STAMP_HEAD, 1),
        ("  extern __shared__ float4 smem4[];\n",
         "  extern __shared__ float4 smem4[];\n"
         "  const long long t_begin = clock64();\n"
         "  long long t_stage = 0, t_bank = 0;\n", 1),
        ("    const int rt = r0 + lane * row_step;\n",
         "    const long long ts = clock64();\n"
         "    const int rt = r0 + lane * row_step;\n", 1),
        ("    for (int k = 0; k < 32; ++k) {\n",
         "    t_stage += clock64() - ts;\n"
         "    for (int k = 0; k < 32; ++k) {\n", 1),
        (LOAD_BANK, "              const long long tb = clock64();\n"
         + LOAD_BANK + "              t_bank += clock64() - tb;\n", 1),
        ("        if (valid > 0) store4(a, orow + j, d, valid);\n"
         "      }\n    }\n  }\n}\n",
         "        if (valid > 0) store4(a, orow + j, d, valid);\n"
         "      }\n    }\n  }\n" + STAMP_WRITE + "}\n", 1),
    ],
    "dist_tiles_baseline": [
        ("namespace {\n", "namespace {\n" + STAMP_HEAD, 1),
        ("  extern __shared__ float smem[];\n",
         "  extern __shared__ float smem[];\n"
         "  const long long t_begin = clock64();\n"
         "  long long t_bank = 0;\n", 2),
        ("                               qn, gs);\n",
         "                               qn, gs);\n"
         "  const long long t_stage = clock64() - t_begin;\n", 2),
        ("      if (g != cached) {\n",
         "      if (g != cached) {\n        const long long tb = clock64();\n",
         1),
        ("        cached = g;\n",
         "        t_bank += clock64() - tb;\n        cached = g;\n", 1),
        ("    out[(row0 + r) * B + j] = d;\n  }\n}\n",
         "    out[(row0 + r) * B + j] = d;\n  }\n" + STAMP_WRITE + "}\n", 2),
    ],
}
# the redesign's entry takes either store hint
HINT_FREE = [("      streaming != (4LL * rows * B > kStreamBytes ? 1 : 0))",
              "      false)", 1)]


def edited(name: str, edits) -> str:
    from fedmse_tpu_torch.ops import native
    src = (native.CSRC_DIR / f"{name}.cu").read_text()
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"{name}.cu: anchor {old!r} found "
                               f"{src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    return src


def build_variants(variants) -> dict:
    """{tag: CUDA source text} -> {tag: loaded CDLL}, every nvcc started
    together."""
    from fedmse_tpu_torch.ops import native
    out_dir = os.path.join(ROOT, "build", "profile_dist")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, text in variants.items():
        src = os.path.join(out_dir, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{tag}.so")
        procs[tag] = (subprocess.Popen(
            [native.find_nvcc(), *native.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):  # the f32 L = 7 instance's report
            if "Compiling entry" in line and "IfLi7E" in line:
                print(tag, " | ".join(x.split(":", 1)[-1].strip()
                                      for x in lines[k + 1:k + 3]))
        libs[tag] = ctypes.CDLL(lib)
    return libs


def caller(lib, baseline: bool, per_sm: int):
    """fn(q, banks, gw, out, streaming) launching `lib`'s entry on the
    current stream with dist_plan's plan (the hint as given)."""
    import torch
    from fedmse_tpu_torch.knn.score import dist_plan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if baseline:
        lib.dist_tiles.argtypes = [ptr] * 4 + [ctypes.c_longlong] + \
            [i32] * 3 + [ptr]
    else:
        lib.dist_tiles.argtypes = [ptr] * 4 + [ctypes.c_longlong] + \
            [i32] * 8 + [ptr]
    lib.dist_tiles.restype = i32

    def call(q, banks, gw, out, streaming=False):
        rows, lat = q.shape
        n, b, _ = banks.shape
        stream = torch.cuda.current_stream().cuda_stream
        gp = None if gw is None else gw.data_ptr()
        if baseline:
            rc = lib.dist_tiles(q.data_ptr(), banks.data_ptr(), gp,
                                out.data_ptr(), rows, n, b, lat, stream)
        else:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            groups, ctas, _ = dist_plan(rows, b, lat, sms)
            ctas = min(-(-rows // (8 // (groups // 32))), per_sm * sms)
            rc = lib.dist_tiles(q.data_ptr(), banks.data_ptr(), gp,
                                out.data_ptr(), rows, n, b, lat,
                                int(q.dtype == torch.bfloat16), groups, ctas,
                                int(streaming), 0, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_dist: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fedmse_tpu_torch.knn.bank import ReferenceBank
    from fedmse_tpu_torch.knn.score import (_kth_of_smallest, _mask_padding,
                                            _smallest_k, dist_tiles_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    libs = build_variants({
        "stamped": edited("dist_tiles", STAMPS["dist_tiles"] + HINT_FREE)
        + STAMP_TAKE,
        "stamped_baseline": edited("dist_tiles_baseline",
                                   STAMPS["dist_tiles_baseline"]) + STAMP_TAKE,
        "hint_free": edited("dist_tiles", HINT_FREE),
        "hint_free_4": edited("dist_tiles", HINT_FREE + [
            ("kBlocksPerSM = 3;", "kBlocksPerSM = 4;", 1)]),
        "baseline": edited("dist_tiles_baseline", []),
    })
    for lib in (libs["stamped"], libs["stamped_baseline"]):
        lib.stamps_take.argtypes = [ctypes.c_void_p]
        lib.stamps_take.restype = ctypes.c_int
    calls = {tag: caller(lib, "baseline" in tag, 4 if tag.endswith("_4")
                         else 3) for tag, lib in libs.items()}

    gen = torch.Generator().manual_seed(cs.SEED + 9)
    bank = cs.KNN["knn_bank_size"]
    lat = cs.DIMS[2]
    shapes = list(cs.main_dist_shapes(30_000))
    shapes.append(("1024 rows client-major, 512 gateways", 512, 1024,
                   "client_major"))
    one = torch.zeros(1, device=device)
    result = {"device": cs.smi_line(), "shapes": [],
              "fill_one_element_device_ms": cs.all_device_ms(
                  torch, lambda: one.fill_(1.0), 50)}
    for what, n, rows, gw_kind in shapes:
        q, banks, gw = cs.dist_inputs(torch, n, rows, bank, lat, gw_kind,
                                      gen, device, torch.float32)
        out = torch.empty((rows, bank), device=device)
        want = dist_tiles_plain(q, banks, gw)
        entry = {"what": what, "rows": rows, "banks": n}
        for tag in ("stamped", "stamped_baseline"):
            lib = libs[tag]
            calls[tag](q, banks, gw, out)
            torch.cuda.synchronize()
            host = (ctypes.c_ulonglong * 4)()
            lib.stamps_take(host)  # reset after the warm-up
            calls[tag](q, banks, gw, out)
            torch.cuda.synchronize()
            if lib.stamps_take(host) != 0:
                raise RuntimeError("reading the stamps failed")
            ctas = max(int(host[3]), 1)
            entry[tag] = {"ctas": int(host[3]),
                          "stage_cycles": host[0] / ctas,
                          "bank_cycles": host[1] / ctas,
                          "total_cycles": host[2] / ctas}
            err = cs.scaled_err(out, want)
            if err > cs.DIST_TOL:
                raise AssertionError(f"{tag} {what}: {err:.3e}")
        counts = torch.randint(bank // 2, bank + 1, (n,), generator=gen,
                               dtype=torch.int32).to(device)
        ref = ReferenceBank(latents=banks, count=counts)
        g = gw if gw is not None else torch.zeros(rows, dtype=torch.int32,
                                                  device=device)
        got = {}
        for tag, streaming in (("baseline", False), ("hint_free", False),
                               ("hint_free", True), ("hint_free_4", False),
                               ("hint_free_4", True)):
            key = tag + ("_evict_first" if streaming else "")
            fn = calls[tag]
            kernel = lambda: fn(q, banks, gw, out, streaming)  # noqa: E731

            def path(fn=fn, streaming=streaming):
                d = fn(q, banks, gw, torch.empty_like(out), streaming)
                c = ref.count[g.long()]
                return _kth_of_smallest(_smallest_k(
                    _mask_padding(d, c), cs.KNN["knn_k"], "exact", 512, 32),
                    c, cs.KNN["knn_k"])
            got[key] = kernel().clone()
            entry[key] = {
                "kernel_device_ms": cs.device_ms(kernel, "dist_tiles", 50),
                "path_device_ms": cs.all_device_ms(torch, path, 40),
                "path_ms": cs.cuda_ms(path, 50)}
        entry["bit_equal_to_baseline"] = all(
            torch.equal(v.view(torch.int32), got["baseline"].view(torch.int32))
            for v in got.values())
        result["shapes"].append(entry)
        print(json.dumps(entry), flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
