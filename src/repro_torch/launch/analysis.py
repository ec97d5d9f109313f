"""Roofline terms on one NVIDIA H100, from a dry run's host counts.

The port of ``repro/launch/analysis.py``, with the card's constants in
place of the TPU v5e's (NVIDIA's H100 SXM data sheet, dense rates, at the
full 700 W power limit):

  PEAK_FLOPS = 989e12  bf16 FLOP/s on the tensor cores
  HBM_BW     = 3.35e12 B/s of HBM3
  LINK_BW    = 450e9   B/s of NVLink 4, one direction (900 GB/s both ways)

Terms (per card, per step):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes accessed / HBM_BW
  collective = collective bytes / LINK_BW

The FLOPs and bytes come from the dry run's host counts
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.dryrun_solver`),
not from the card: a term is the least time the card could take for that
work at these rates.

collective_bytes keeps the JAX module's convention: the sum over
collectives of the RESULT buffer size, weighted 2x for an all-reduce (a
ring's reduce-scatter + all-gather moves ~2x the payload per device) and 1x
otherwise, by the five kinds, with a count of each.  JAX parses them from
HLO text; the port has no compiler IR, so the input is what its meshes
count as they run (``SolverMesh.coll_bytes``/``coll_counts``), one entry a
collective actually issued.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# the card's memory where no card is present to ask: the data sheet's 80 GB
# of HBM3, taken as GiB (on a card, get_device_properties(0).total_memory)
CARD_BYTES_DEFAULT = 80 * 2**30

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def collective_bytes(result_bytes: dict, counts: dict) -> dict:
    """{kind: weighted bytes, ..., 'total', 'counts'} from the result bytes
    and the count of each kind issued (kinds absent: 0), as JAX's
    ``collective_bytes`` returns it for an HLO module."""
    out = {k: (2 if k == "all-reduce" else 1) * int(result_bytes.get(k, 0))
           for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = {k: int(counts.get(k, 0)) for k in COLLECTIVES}
    return out


def roofline(flops: float, bytes_accessed: float, coll_bytes: float) -> dict:
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    coll_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(compute_s, memory_s, coll_s)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound_s,
        # fraction of the roofline the compute term occupies: 1.0 means the
        # step is perfectly compute-bound (the best a fixed algorithm can do)
        "compute_fraction": compute_s / bound_s if bound_s else 0.0,
    }


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) useful-FLOPs estimate; forward-only
    kinds use 2·N·D.  D = tokens processed in the step."""
    n_active = cfg.active_params_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_share(cfg, shape, step_s: float) -> float:
    """The step's model FLOPs over the card's bf16 peak, divided by its
    measured time: the share of the compute roofline the step reached."""
    return model_flops(cfg, shape) / PEAK_FLOPS / step_s
