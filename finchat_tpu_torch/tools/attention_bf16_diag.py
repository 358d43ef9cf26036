"""What paces the Hopper bf16 prefill attention body, on one H100.

    python -m finchat_tpu_torch.tools.attention_bf16_diag [--contiguous | --backward]

Times, at the prefill shapes of ``chip_smoke.py`` (Llama-3-8B heads, page
128; a 4 x 512 chunk at q_offset 0, 1024 and 2048), the older bf16 body
(``paged_attention.cu``, launched by name), the Hopper bf16 body
(``attention_bf16_sm90.cu``) and three diagnostic builds of it, each a copy
of the sources with one stage cut out by text substitution (the script
fails if a substitution no longer matches):

- ``no fetch``: no TMA copies into the ring (the producer arrives on each
  stage's barrier without bytes), so the products and the softmax run on
  whatever the ring holds;
- ``no products``: no ``wgmma``; the scores are made from the Q fragments
  and the P fragments folded into the output, so the fetch and the softmax
  still run;
- ``neither``: both cuts, what the softmax, the barriers and the loop cost
  alone.

Beside each case: the bound (the larger of the bytes — q in and out, each
key's K and V once — over 3.35 TB/s and the FLOPs the causal chunk needs
over 989 TFLOP/s) and the query tiles a block (``query_tiles_per_block``).

Then the query tiles a block: the Hopper body on the same inputs forced to
one and to two tiles a block, beside the rule's choice, for a lone chunk
(B=1 x 512 at q_offset 0 and 2048), the serving chunk (4 x 512) and short
final chunks (B=1, C=64 and 128 at q_offset 2048); and the same for the
body's ragged entry (``ragged_paged_attention_sm90``, a bf16 round's
prefill tiles) over the two ragged rounds of ``chip_smoke.py`` — two
512-token rows at q_offset 0 and 1024 beside 60 decode rows over 1-4k, and
three 512-token rows at q_offset 1024, 2048 and 4096 beside 4 decode rows
at 5,236 tokens, both in a 2048 bucket of 64 rows, the 60 decode rows
alone (what the entry's blocks that return at once cost), and a 64-token
chunk beside 4 decode rows in a 128 bucket (one-tile blocks fit a wave) —
with the decode body's ragged entry and the pair beside them.

Then, or alone with ``--contiguous``, the body's contiguous entry
(``flash_attention_sm90``, K7's forward) at K7's two cases in
``chip_smoke.py`` — causal B=1 S=2048 (the training step's call) and B=4
Sq=512 at q_offset 1024 over 1,536 keys — at one and at two query tiles a
block beside the rule's choice, the three diagnostic builds, and the older
forward (``flash_attention.cu``) by name.

With ``--backward``, only K7's Hopper backward (``flash_attention_bwd_sm90.cu``)
at the same two cases, on the Hopper forward's out and lse: ptxas's registers
and spills of the source as it is, then the kernel and three diagnostic
builds of it — ``no fetch`` (neither ring is
filled: the producer arrives on each stage's barrier without bytes),
``no products`` (no ``wgmma``) and ``no elementwise`` (P and dS not formed:
the scores go to the second products as they are) — and the older backward
by name, each as a launch's device time by kernel (the pre-pass, the dK/dV
body, the dQ body; ``torch.profiler`` over 20 launches) beside the whole
launch's time by CUDA events, with each body's share of the bound: the
dK/dV body's four products and the dQ body's three over 989 TFLOP/s.
The diagnostic builds compute garbage and are only timed. Every time is the
median over 20 CUDA-event-timed runs of back-to-back launches (each launch
prepared once, ``prepare_paged``); nvcc's register and spill counts of each
build are printed. Needs a CUDA device and nvcc; writes its builds under
``finchat_tpu_torch/build/diag/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys

import torch

from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.flash_attention import prepare_flash, prepare_flash_bwd
from finchat_tpu_torch.ops.paged_attention import (
    prepare_paged,
    query_tiles_per_block,
    sm_count,
)
from finchat_tpu_torch.ops.ragged_paged_attention import prepare_ragged
from finchat_tpu_torch.tools.attention_q8_diag import (
    _page_table,
    build_variant,
    kernel_from,
    timed,
)

H, HKV, D, PS = 32, 8, 128, 128
SOURCE = "attention_bf16_sm90.cu"
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# (source file, text to cut, its replacement) per diagnostic build
_NO_FETCH = [
    (SOURCE, "    fct::mbar_expect_tx(bar, nb * 4 * kBoxBytes);\n", "    fct::mbar_arrive(bar);\n"),
    (SOURCE, "      fct::tma_load_2d(st, kmap, bar, g * D, row);\n"
             "      fct::tma_load_2d(st + kPanel, kmap, bar, g * D + 64, row);\n"
             "      fct::tma_load_2d(st + kV, vmap, bar, g * D, row);\n"
             "      fct::tma_load_2d(st + kV + kPanel, vmap, bar, g * D + 64, row);\n",
     "      (void)st, (void)row;\n"),
]
_NO_PRODUCTS = [
    (SOURCE, "    wgmma_m64n128k16_rs<0>(s, qf[ks], fct::sw128_desc(stage + (ks / 4) * kPanel)"
             " + 2 * (ks % 4),\n                           ks > 0);\n",
     "    for (int i = 0; i < 8; ++i) s[8 * ks + i] = __uint_as_float(qf[ks][i % 4] & 0x3f7fffffu);\n"),
    (SOURCE, "    wgmma_m64n128k16_rs<1>(o, pf[kk], v_desc(stage + kV + kk * 16 * 128), 1);\n",
     "    o[kk] += __uint_as_float(pf[kk][0] & 0x3f7fffffu);\n"),
]
VARIANTS = {"no fetch": _NO_FETCH, "no products": _NO_PRODUCTS,
            "neither": _NO_FETCH + _NO_PRODUCTS}

BWD_SOURCE = "flash_attention_bwd_sm90.cu"
BWD_NAME = "flash_attention_bwd_sm90"
_BWD_NO_FETCH = [
    (BWD_SOURCE, "    fct::mbar_expect_tx(bar, 2 * kTile + kLd * 4);\n"
                 "    for (int h = 0; h < 2; ++h) {\n"
                 "      fct::tma_load_4d(st + h * kPanel, &qmap, bar, h * 64, g << gshift, t * BQ, b);\n"
                 "      fct::tma_load_4d(st + kTile + h * kPanel, &omap, bar, h * 64, g << gshift, t * BQ, b);\n"
                 "    }\n"
                 "    fct::bulk_load(base + LD_OFF + s * kLd * 4, ld_bg + (long)t * kLd, kLd * 4, bar);\n",
     "    fct::mbar_arrive(bar);\n    (void)st, (void)t;\n"),
    (BWD_SOURCE, "        fct::mbar_expect_tx(bar, 2 * kTile);\n"
                 "        for (int h = 0; h < 2; ++h) {\n"
                 "          fct::tma_load_4d(st + h * kPanel, &kmap, bar, h * 64, g, kt * kRows, b);\n"
                 "          fct::tma_load_4d(st + kTile + h * kPanel, &vmap, bar, h * 64, g, kt * kRows, b);\n"
                 "        }\n",
     "        fct::mbar_arrive(bar);\n        (void)st;\n"),
]
_BWD_NO_PRODUCTS = [
    (BWD_SOURCE, "    if (ks == 0) {\n"
                 "      fct::wgmma_m64n64k16_ss_first(d, da, db);\n"
                 "    } else {\n"
                 "      fct::wgmma_m64n64k16_ss(d, da, db);\n"
                 "    }\n",
     "    for (int i = 0; i < 4; ++i) d[4 * ks + i] = __uint_as_float((uint32_t)(da ^ db) & 0x3f7fffffu);\n"),
    (BWD_SOURCE, "    fct::wgmma_m64n128k16_rs<1>(acc, f[kk], dt, 1);\n",
     "    acc[kk] += __uint_as_float((f[kk][0] ^ (uint32_t)dt) & 0x3f7fffffu);\n"),
]
_BWD_NO_ELEMENTWISE = [
    (BWD_SOURCE, "      if (masked) {\n"
                 "        probs_t<true>(st, pf, lds, k0 + r_a, kvl, pos0, gshift, c2, lane);\n"
                 "      } else {\n"
                 "        probs_t<false>(st, pf, lds, k0 + r_a, kvl, pos0, gshift, c2, lane);\n"
                 "      }\n",
     "      for (int i = 0; i < 16; ++i) pf[i / 4][i % 4] = fct::pack_bf16(st[2 * i], st[2 * i + 1]);\n"
     "      (void)masked;\n"),
    (BWD_SOURCE, "      if (masked) {\n"
                 "        dscores_t<true>(st, dpt, sf, lds, lane);\n"
                 "      } else {\n"
                 "        dscores_t<false>(st, dpt, sf, lds, lane);\n"
                 "      }\n",
     "      for (int i = 0; i < 16; ++i) sf[i / 4][i % 4] = fct::pack_bf16(st[2 * i], dpt[2 * i]);\n"),
    (BWD_SOURCE, "    if (k0 + kRows - 1 > pos_lo || k0 + kRows > kvl) {\n"
                 "      grads_q<true>(sc, dp, sf, l2, dl, pos, k0, kvl, c2, lane);\n"
                 "    } else {\n"
                 "      grads_q<false>(sc, dp, sf, l2, dl, pos, k0, kvl, c2, lane);\n"
                 "    }\n",
     "    for (int i = 0; i < 16; ++i) sf[i / 4][i % 4] = fct::pack_bf16(sc[2 * i], dp[2 * i]);\n"
     "    (void)l2, (void)dl, (void)pos;\n"),
]
BWD_VARIANTS = {"no fetch": _BWD_NO_FETCH, "no products": _BWD_NO_PRODUCTS,
                "no elementwise": _BWD_NO_ELEMENTWISE}


def bound_ms(q_offset: int, B: int = 4, C: int = 512) -> float:
    """The least time of one 4 x C chunk at ``q_offset``: bytes (q in, out,
    K and V of every key once) or causal FLOPs, whichever is larger."""
    kv_len = q_offset + C
    moved = 2 * B * C * H * D * 2 + B * kv_len * HKV * D * 2 * 2
    keys = B * sum(q_offset + i + 1 for i in range(C))
    return max(moved / HBM_BYTES_PER_S, 4.0 * keys * H * D / BF16_FLOPS_PER_S) * 1e3


def _inputs(gen, dev, B: int, C: int, q_off: int):
    """A paged call of ``B`` sequences of ``C`` query tokens at ``q_off``
    over a random cache of two layers (layer 1 read)."""
    kv_lens = [q_off + C] * B
    n_pages = 2 + sum(-(-n // PS) for n in kv_lens)
    shape = (2, n_pages, PS, HKV * D)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((B, C, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    return (q, k, v, _page_table(gen, dev, kv_lens, n_pages),
            torch.full((B,), q_off, dtype=torch.int32, device=dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev), 1)


def with_tiles(prep: kernels.Prepared, tiles: int) -> kernels.Prepared:
    """A prepared launch of the bf16 Hopper body with ``tiles`` query tiles a
    block in place of the rule's (the argument before the scale)."""
    *head, _rule, scale = prep.args
    return dataclasses.replace(prep, args=(*head, tiles, scale))


def time_tiles(gen, dev) -> None:
    """The body at one and at two query tiles a block, on the same inputs."""
    name = "paged_attention_sm90"
    print("query tiles a block (ms at 1 / 2 tiles; the rule's choice):")
    for B, C, q_off in ((1, 512, 0), (1, 512, 2048), (4, 512, 0), (4, 512, 2048),
                        (1, 64, 2048), (1, 128, 2048)):
        args = _inputs(gen, dev, B, C, q_off)
        prep = prepare_paged(name, *args, page_size=PS, n_kv=HKV, route=False)
        rule = query_tiles_per_block(B, C, H // HKV, HKV, sm_count(dev))
        ref = prep.launch().clone()
        ms = []
        for tiles in (1, 2, 1, 2):
            launch = with_tiles(prep, tiles)
            if not torch.equal(launch.launch(), ref):
                raise SystemExit(f"{B}x{C} at q{q_off}: {tiles} tiles a block change the output")
            ms.append(timed(launch.launch, name, None))
        print(f"  {B}x{C} at q{q_off} (bound {bound_ms(q_off, B, C):.4f}): "
              f"{ms[0]:.4f} / {ms[1]:.4f}, again {ms[2]:.4f} / {ms[3]:.4f}; rule {rule}",
              flush=True)
        del args, prep, ref
        torch.cuda.empty_cache()


def _ragged_inputs(gen, dev, spans, T: int, R: int = 64):
    """A bf16 round of ``spans`` ((tokens, first position) per row, empty
    rows up to ``R``) padded to ``T`` tokens over a random cache of two
    layers (layer 1 read)."""
    spans = list(spans) + [(0, 0)] * (R - len(spans))
    kv_lens = [n + p0 for n, p0 in spans]
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    shape = (2, n_pages, PS, HKV * D)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    tok_row = [r for r, (n, _p) in enumerate(spans) for _ in range(n)]
    tok_pos = [p0 + i for n, p0 in spans for i in range(n)]
    pad = T - len(tok_row)
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.randn((T, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    return (q, k, v, _page_table(gen, dev, kv_lens, n_pages),
            torch.tensor(tok_row + [R] * pad, **i32), torch.tensor(tok_pos + [0] * pad, **i32),
            torch.tensor(kv_lens, **i32), 1)


def time_ragged_tiles(gen, dev) -> None:
    """The ragged entry at one and at two tiles a block on the same rounds
    (the prefill rows' outputs must not change), the decode entry and the
    pair as routed."""
    name = "ragged_paged_attention_sm90"
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    rounds = {"2x512 + 60 decode rows": [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec],
              "3x512 + 4 decode rows at 5236": [(512, 1024), (512, 2048), (512, 4096)]
              + [(1, 5235)] * 4}
    # no prefill row: what the entry's blocks that return at once (or only
    # zero the padding) cost on their own
    rounds["60 decode rows alone"] = [(1, n - 1) for n in dec]
    # a small bucket, where one-tile blocks fit a wave: a final 64-token
    # chunk at q_offset 2048 beside 4 decode rows
    rounds["64 tokens + 4 decode rows, 128 bucket"] = [(64, 2048)] + [(1, 5235)] * 4
    print("ragged entry, tiles a block (ms at 1 / 2 tiles; the rule's choice):")
    for label, spans in rounds.items():
        args = _ragged_inputs(gen, dev, spans, 128 if "128 bucket" in label else 2048)
        prep = prepare_ragged(name, *args, page_size=PS, n_kv=HKV, route=False)
        rule = prep.args[-2]
        n_pre = sum(n for n, _p in spans if n > 1)  # the prefill rows come first
        ref = prep.launch().clone()
        ms = []
        for tiles in (1, 2, 1, 2):
            launch = with_tiles(prep, tiles)
            if not torch.equal(launch.launch()[:n_pre], ref[:n_pre]):
                raise SystemExit(f"{label}: {tiles} tiles a block change the output")
            ms.append(timed(launch.launch, name, None))
        pair = prepare_ragged("ragged_paged_attention", *args, page_size=PS, n_kv=HKV)
        dec_ms = timed(pair.parts[1].launch, pair.parts[1].name, None)
        pair_ms = timed(pair.launch, name, None)
        print(f"  {label}: {ms[0]:.4f} / {ms[1]:.4f}, again {ms[2]:.4f} / {ms[3]:.4f}; rule "
              f"{rule}; decode entry {dec_ms:.4f}, the pair {pair_ms:.4f}", flush=True)
        del args, prep, ref, pair
        torch.cuda.empty_cache()


def time_contiguous(gen, dev, libs) -> None:
    """The contiguous entry at K7's two cases: one and two query tiles a
    block (the outputs and log-sum-exps must not change), the diagnostic
    builds and the older forward by name."""
    name = "flash_attention_sm90"
    print("contiguous entry (K7's forward; ms):")
    for B, Sq, Sk, q_off in ((1, 2048, 2048, 0), (4, 512, 1536, 1024)):
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn((B, Sk, HKV, D), generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        qo = torch.full((B,), q_off, dtype=torch.int32, device=dev)
        kl = torch.full((B,), Sk, dtype=torch.int32, device=dev)
        prep = prepare_flash(q, k, v, qo, kl, causal=True, scale=D ** -0.5)
        assert prep.name == name
        rule = prep.args[-2]
        ref = prep.launch().clone(), prep.aux.clone()
        ms = []
        for tiles in (1, 2, 1, 2):
            launch = with_tiles(prep, tiles)
            if not (torch.equal(launch.launch(), ref[0]) and torch.equal(launch.aux, ref[1])):
                raise SystemExit(f"{B}x{Sq} at q{q_off}: {tiles} tiles a block change the output")
            ms.append(timed(launch.launch, name, None))
        keys = B * sum(min(q_off + i + 1, Sk) for i in range(Sq))
        moved = 2 * B * Sq * H * D * 2 + 2 * B * Sk * HKV * D * 2 + B * H * Sq * 4
        bound = max(moved / HBM_BYTES_PER_S, 4.0 * keys * H * D / BF16_FLOPS_PER_S) * 1e3
        old = prepare_flash(q, k, v, qo, kl, causal=True, scale=D ** -0.5,
                            kernel="flash_attention")
        print(f"  {B}x{Sq} at q{q_off} over {Sk} keys (bound {bound:.4f}): tiles 1 / 2 "
              f"{ms[0]:.4f} / {ms[1]:.4f}, again {ms[2]:.4f} / {ms[3]:.4f}; rule {rule}; "
              + ", ".join(f"{label} {timed(prep.launch, name, lib):.4f}"
                          for label, lib in libs.items())
              + f"; older forward {timed(old.launch, old.name, None):.4f}", flush=True)
        del q, k, v, prep, old, ref
        torch.cuda.empty_cache()


def device_ms_by_kernel(launch, n: int = 20) -> dict[str, float]:
    """Device ms a launch of each kernel a prepared launch runs, from
    ``torch.profiler`` over ``n`` launches."""
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    got: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        found = re.search(r"flash_bwd_\w+", ev.key)
        if us and found:
            got[found.group(0)] = got.get(found.group(0), 0.0) + us / 1e3 / n
    return got


def time_backward(gen, dev, libs) -> None:
    """K7's Hopper backward at K7's two cases: the kernel, its diagnostic
    builds and the older backward by name, by kernel and as a whole."""
    print("K7's backward (ms a launch; by kernel from the profiler, the whole launch by events):")
    for B, Sq, Sk, q_off in ((1, 2048, 2048, 0), (4, 512, 1536, 1024)):
        q, dout = (torch.randn((B, Sq, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
                   for _ in range(2))
        k, v = (torch.randn((B, Sk, HKV, D), generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        qo = torch.full((B,), q_off, dtype=torch.int32, device=dev)
        kl = torch.full((B,), Sk, dtype=torch.int32, device=dev)
        kw = dict(causal=True, scale=D ** -0.5)
        fwd = prepare_flash(q, k, v, qo, kl, **kw)
        out, lse = fwd.launch(), fwd.aux
        call = prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw)
        assert call.name == BWD_NAME
        old = prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw, kernel="flash_attention_bwd")
        pairs = B * sum(min(q_off + i + 1, Sk) for i in range(Sq))
        b_dkdv = 8.0 * pairs * H * D / BF16_FLOPS_PER_S * 1e3  # S^T, dP^T, dV, dK
        b_dq = 6.0 * pairs * H * D / BF16_FLOPS_PER_S * 1e3  # S, dP, dQ
        print(f"  {B}x{Sq} at q{q_off} over {Sk} keys (bound of the five products "
              f"{10.0 * pairs * H * D / BF16_FLOPS_PER_S * 1e3:.4f}; the dK/dV body's four "
              f"{b_dkdv:.4f}, the dQ body's three {b_dq:.4f}):", flush=True)
        for label, lib in [("kernel", None)] + list(libs.items()) + [("kernel, again", None)]:
            with kernel_from(BWD_NAME, lib):
                parts = device_ms_by_kernel(call.launch)
            whole = timed(call.launch, BWD_NAME, lib)
            shares = ", ".join(
                f"{n.removeprefix('flash_bwd_').removesuffix('_sm90_kernel')} {ms:.4f}"
                + (f" (share {b_dkdv / ms:.2f})" if "dkdv" in n and label == "kernel" else "")
                + (f" (share {b_dq / ms:.2f})" if "_dq_" in n and label == "kernel" else "")
                for n, ms in sorted(parts.items()))
            print(f"    {label}: {whole:.4f}; {shares}", flush=True)
        print(f"    older backward: {timed(old.launch, old.name, None):.4f}", flush=True)
        del q, dout, k, v, fwd, out, lse, call, old
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--contiguous", action="store_true",
                      help="time the contiguous entry (K7's forward) only")
    mode.add_argument("--backward", action="store_true",
                      help="time K7's Hopper backward only")
    opts = parser.parse_args()
    contiguous_only = opts.contiguous
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{torch.cuda.get_device_name(0)} ({smi.stdout.strip()})")
    kernels.build_all()
    print("builds:")
    if opts.backward:
        build_variant("bwd_kernel", BWD_SOURCE, [])  # ptxas's registers and spills of the kernel
        libs = {label: build_variant("bwd_" + label.replace(" ", "_"), BWD_SOURCE, cuts)
                for label, cuts in BWD_VARIANTS.items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(1234)
        time_backward(gen, dev, libs)
        return
    libs = {label: build_variant("bf16_" + label.replace(" ", "_"), SOURCE, cuts)
            for label, cuts in VARIANTS.items()}

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    if contiguous_only:
        time_contiguous(gen, dev, libs)
        return
    kw = dict(page_size=PS, n_kv=HKV)
    new, old = "paged_attention_sm90", "paged_attention"
    for q_off in (0, 1024, 2048):
        args = _inputs(gen, dev, 4, 512, q_off)
        tiles = query_tiles_per_block(4, 512, H // HKV, HKV, sm_count(dev))
        print(f"paged prefill 4x512 at q{q_off} (ms; bound {bound_ms(q_off):.4f}, "
              f"{tiles} query tiles a block):")
        rows = [("old body", old, None), ("new body", new, None)]
        rows += [(f"new, {label}", new, lib) for label, lib in libs.items()]
        rows += [("new body, again", new, None), ("old body, again", old, None)]
        for label, name, lib in rows:
            launch = prepare_paged(name, *args, **kw, route=False).launch
            print(f"  {label}: {timed(launch, name, lib):.4f}", flush=True)
        del args
        torch.cuda.empty_cache()
    time_tiles(gen, dev)
    time_ragged_tiles(gen, dev)
    time_contiguous(gen, dev, libs)


if __name__ == "__main__":
    sys.exit(main())
