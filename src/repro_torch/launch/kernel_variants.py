"""Source variants of the LM kernels, built and timed side by side on the card.

  PYTHONPATH=src python -m repro_torch.launch.kernel_variants [--rounds 2]

Each variant is a committed kernel source with a few text edits
(``VARIANTS``), written to ``build/repro_torch_kernels/variants/`` and built
by :mod:`repro_torch.kernels.build` as the library it replaces.  At the
serving shapes, each is checked against the plain version and timed with
``timing.time_ms``: the tensor-core ``flash_attention`` at qwen1.5-0.5b's
prefill (B 4, S 1024, 16 heads of 64, causal, bf16), starcoder2-3b's widths
(24 query heads, 2 KV heads of 128) and a 256-key window; ``wkv6`` at
RWKV6-3B's prefill (B 4, T 1024, 40 heads, K = V = 64, f32).  Prints, per
variant and round, the registers ptxas gave its kernels, the output
elements more than one bf16 step from the plain version (attention) or the
largest error (wkv6), and the times; then SDPA's, for scale.  Variants that
skip work (``no_pv``, ``no_loads``) are wrong on purpose: they measure what
the skipped part costs.  Rounds interleave the variants, so a drift of the
card shows as a spread between rounds.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.launch.timing import time_ms

_FA_LOOP = "        mbar_expect_tx(&full_bar[st], 2 * NP * kPanelBytes);\n"
_FA_PV = "      for (int t = 0; t < kPSplit; ++t) wgmma_rs(o, a[t][kk], dv);\n"
# library -> variant -> [(text in the committed source, replacement)]
VARIANTS = {
    "flash_attention_wgmma": {
        "committed": [],
        "p_terms_2": [("constexpr int kPSplit = 3;", "constexpr int kPSplit = 2;")],
        "p_terms_1": [("constexpr int kPSplit = 3;", "constexpr int kPSplit = 1;")],
        "no_pv": [(_FA_PV, "")],
        # after the ring's first fill the producer only arrives: stale tiles
        "no_loads": [(_FA_LOOP, "        if (it >= kStages) { mbar_arrive(&full_bar[st]); continue; }\n"
                      + _FA_LOOP)],
        "blocks_3": [("__launch_bounds__(kThreads) flash", "__launch_bounds__(kThreads, 3) flash")],
        "blocks_4": [("__launch_bounds__(kThreads) flash", "__launch_bounds__(kThreads, 4) flash")],
        "stages_3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    },
    "wkv6": {
        "committed": [],
        "unroll_4": [("#pragma unroll 2\n    for (int tt = 0;", "#pragma unroll 4\n    for (int tt = 0;")],
        "chunk_16": [("constexpr int kChunk = 8;", "constexpr int kChunk = 16;")],
        "blocks_8": [("__launch_bounds__(kThreads) wkv6", "__launch_bounds__(kThreads, 8) wkv6")],
        "stages_3": [("constexpr int kStages = 2; ", "constexpr int kStages = 3; ")],
        "stages_4": [("constexpr int kStages = 2; ", "constexpr int kStages = 4; ")],
    },
}
ATTN_SHAPES = {  # name -> (B, S, Hq, Hkv, D, window)
    "qwen": (4, 1024, 16, 16, 64, None),
    "gqa128": (4, 1024, 24, 2, 128, None),
    "window": (4, 1024, 16, 16, 64, 256),
}


def _use_variant(lib: str, name: str, edits, committed) -> list[str]:
    """Points ``build`` at the variant's source (the wrapper then loads its
    library); returns ptxas's register lines if it was built now."""
    text = committed.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"kernel_variants: {lib}/{name}: {old!r} is not in {committed}")
        text = text.replace(old, new)
    src = build.BUILD_DIR / "variants" / f"{lib}_{name}" / committed.name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    build.SOURCES[lib] = src
    build._LIBS.pop(lib, None)
    build.BUILD_LOG.pop(lib, None)
    return re.findall(r"Used \d+ registers[^\n]*", build.build_all([lib]).get(lib, ""))


def _one_step_bad(got: torch.Tensor, want: torch.Tensor) -> int:
    got, want = got.float(), want.float()
    step = 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6
    return int(((got - want).abs() > step).sum())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}")

    g = torch.Generator(device=dev).manual_seed(0)
    attn = {}
    for shape, (B, S, Hq, Hkv, D, window) in ATTN_SHAPES.items():
        q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        attn[shape] = (q, k, v, window, flash_attention_plain(q, k, v, window=window))
    # wkv6's inputs, drawn as JAX's test draws them
    rkv = [torch.randn(4, 1024, 40, 64, generator=g, device=dev) * 0.5 for _ in range(3)]
    w = torch.rand((4, 1024, 40, 64), generator=g, device=dev) * 2.8 + 0.2
    wkv_in = (*rkv, torch.exp(-torch.exp(-w)), torch.randn(40, 64, generator=g, device=dev) * 0.3)
    o_ref, s_ref = wkv6_ref(*wkv_in)

    registers = {}
    committed = dict(build.SOURCES)
    try:
        for rnd in range(args.rounds):
            for name, edits in VARIANTS["flash_attention_wgmma"].items():
                regs = _use_variant("flash_attention_wgmma", name, edits,
                                    committed["flash_attention_wgmma"])
                registers.setdefault(("attention", name), regs)
                bad, times = {}, {}
                for shape, (q, k, v, window, want) in attn.items():
                    fn = lambda: flash_attention(q, k, v, window=window, variant="tensor_core")
                    bad[shape] = _one_step_bad(fn(), want)
                    times[shape] = time_ms(fn)
                print(f"[variants] round {rnd} attention {name}: {registers['attention', name]}; "
                      f"elements over one bf16 step {bad}; ms {times}", flush=True)
            for name, edits in VARIANTS["wkv6"].items():
                regs = _use_variant("wkv6", name, edits, committed["wkv6"])
                registers.setdefault(("wkv6", name), regs)
                o, s = wkv6(*wkv_in)
                err = max(float((o - o_ref).abs().max()), float((s - s_ref).abs().max()))
                ms = time_ms(lambda: wkv6(*wkv_in))
                print(f"[variants] round {rnd} wkv6 {name}: {registers['wkv6', name]}; max abs err "
                      f"{err:.3g}; ms {ms:.6f}", flush=True)
            q, k, v, _, _ = attn["qwen"]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            print(f"[variants] round {rnd} scaled_dot_product_attention (qwen): ms {sdpa:.6f}")
    finally:
        build.SOURCES.clear()
        build.SOURCES.update(committed)
        build._LIBS.clear()


if __name__ == "__main__":
    main()
