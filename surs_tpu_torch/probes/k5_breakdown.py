"""Where kernel K5 (the row gather) spends its time at the gather probe's
shape: a [16384, 256] bf16 map, 49,152 indices.

    python -m surs_tpu_torch.probes.k5_breakdown

Builds ablated copies of ``csrc/row_gather.cu`` (into
``csrc/_build/k5_breakdown/``) and times both variants of each on the
default launch plan, cold with clean L2 lines and warm
(``k5_times``):

- ``full``: the kernel as built;
- ``no_hints``: vec's map loads and output stores without cache hints
  (no L2 evict_last, no streaming store);
- ``no_store``: vec loads its rows and stores (almost) none: the read
  side, index loads included;
- ``no_load``: vec stores a value made from the index instead of the
  row: the write side, index loads included;
- ``no_index``: vec's rows come from a hash of the position instead of
  the index array: no index round trip;
- ``unroll4`` / ``unroll16``: 4 or 16 loads in flight a lane instead of 8;
- ``loop_no_store``: loop copies its rows into the ring and writes no
  tile back;
- ``loop_no_load``: loop writes its tiles back from stages that no row
  was copied into.

and beside them two yardsticks: ``launch``, the full kernel at one index
(the launch and its fixed costs), and ``fill``, PyTorch's ``zero_`` of
the [49152, 256] bf16 output (writing the output's 25.2 MB alone). The
ablated kernels compute nothing useful; only their times are read. One
JSON line per variant, then the card's name and power limit. Runs only
on a CUDA card.
"""

from __future__ import annotations

import json
import time

from .cols_breakdown import build_variants, card_line

# (file, text, replacement) per ablation; each text must occur once
VEC_STORE = "        if (p0 + 32 * u < total) st_stream(dst + p0 + 32 * u, val[u]);"
ABLATIONS = {
    "full": [],
    "no_hints": [
        ("row_gather.cu",
         '"ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "\n'
         '      "{%0, %1, %2, %3}, [%4], %5;\\n"',
         '"ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\\n"'),
        ("row_gather.cu", '"st.global.cs.v4.u32 [%0]', '"st.global.v4.u32 [%0]')],
    "no_store": [(
        "row_gather.cu", VEC_STORE,
        "        if (p0 + 32 * u < total && val[u].x == 0x7fc00001u &&\n"
        "            val[u].y == 0x7fc00001u)\n"
        "          st_stream(dst + p0 + 32 * u, val[u]);")],
    "no_load": [(
        "row_gather.cu",
        "          x = ld_keep(feat + (long long)r * vecs + v, keep);",
        "          x = make_uint4((unsigned)r, (unsigned)v, 0u, 0u);")],
    "no_index": [
        ("row_gather.cu",
         "  int cur = begin + lane < end ? __ldg(idx + begin + lane) : 0;",
         "  int cur = (int)((begin + lane) * 2654435761LL % rows);"),
        ("row_gather.cu",
         "    const int nxt = nx < end ? __ldg(idx + nx) : 0;",
         "    const int nxt = (int)(nx * 2654435761LL % rows);")],
    "unroll4": [("row_gather.cu", "constexpr int VEC_UNROLL = 8;",
                 "constexpr int VEC_UNROLL = 4;")],
    "unroll16": [("row_gather.cu", "constexpr int VEC_UNROLL = 8;",
                  "constexpr int VEC_UNROLL = 16;")],
    "loop_no_store": [(
        "row_gather.cu",
        "      bulk_s2g(a.out + row0 * a.row_bytes, smem_u32(ring + s * stage_bytes),\n"
        "               (uint32_t)cnt * a.row_bytes);\n",
        "")],
    "loop_no_load": [
        ("row_gather.cu",
         "    if (total) mbar_arrive_tx(bar, total * (unsigned)a.row_bytes);\n"
         "    else mbar_arrive(bar);",
         "    mbar_arrive(bar);"),
        ("row_gather.cu",
         "      bulk_g2s(smem_u32(d), a.feat + (long long)r[j] * a.row_bytes,\n"
         "               a.row_bytes, bar);",
         "")],
}


def main() -> None:
    import torch
    from ..ops import row_gather as rg
    from . import k5_times

    if not torch.cuda.is_available():
        raise SystemExit("k5_breakdown needs a CUDA card")
    t0 = time.perf_counter()
    libs = build_variants("row_gather.cu", ABLATIONS, list(ABLATIONS),
                          "k5_breakdown")
    for lib in libs.values():
        rg.bind(lib)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    feat, idx = k5_times.probe_inputs()
    out = torch.empty((idx.shape[0], feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    plans = {v: rg.device_plan(feat, idx.shape[0], v) for v in rg.VARIANTS}
    one = idx[:1]
    flush, clean = k5_times.cold_buffers()

    def both(fn):
        return {"cold_clean_ms": k5_times.time_cold(fn, 20, flush, clean),
                "warm_ms": k5_times.time_warm(fn)}

    for name, lib in libs.items():
        for v in rg.VARIANTS:
            rec = {"variant": name, "kernel": v, **both(
                lambda: rg.launch(lib, feat, idx, out, v, plans[v]))}
            print(json.dumps(rec), flush=True)
    for v in rg.VARIANTS:
        one_out = out[:1]
        rec = {"variant": "launch", "kernel": v, "n": 1, **both(
            lambda: rg.launch(libs["full"], feat, one, one_out, v))}
        print(json.dumps(rec), flush=True)
    print(json.dumps({"variant": "fill", "bytes": out.numel() * 2,
                      **both(out.zero_)}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
