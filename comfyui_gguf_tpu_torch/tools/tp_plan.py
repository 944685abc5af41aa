"""Tensor-parallel sizing planner: the per-shard bytes of the rule-covered
block weights at each tp, for the published dims, without loading
anything (a CLI around ``parallel.tp_spec.i8_plan_report``, which mirrors
the port's planar padding and int8 footprint).

For each arch (or the one given) and tp in {1, 2, 4, 8} that its head
count divides, it prints the packed bytes a shard holds, planar and fully
int8, and whether they fit a per-card budget. An arch without a head
count is refused: no tp is printed as runnable for it. The budget is
``--budget-gb``, or else the card's memory less ``CARD_MARGIN_GB`` (kept
for activations, the kernels' workspace and the CUDA context); without a
card the flag is required.

    python -m comfyui_gguf_tpu_torch.tools.tp_plan --budget-gb 60
    python -m comfyui_gguf_tpu_torch.tools.tp_plan --arch qwen_image --json
"""

from __future__ import annotations

import argparse
import json
import sys

# held back from the card's memory when the budget comes from the card
CARD_MARGIN_GB = 10.0


def _head_count(dims):
    """The dims' head count (``n_heads`` / ``heads``, else its model
    config's); None when there is none."""
    heads = getattr(dims, "n_heads", None) or getattr(dims, "heads", None)
    if heads is None and hasattr(dims, "config"):
        heads = getattr(dims.config(), "n_heads", None)
    return heads


def _specs():
    from ..models import testing as T
    from ..parallel import tp_spec

    def ent(shape_fn, dims, rules):
        return (shape_fn(dims)[1], rules, _head_count(dims))

    return {
        "flux": ent(T.flux_shape_spec, T.FLUX_DEV_DIMS,
                    tp_spec.flux_rules(T.FLUX_DEV_DIMS.hidden)),
        "qwen_image": ent(T.qwen_image_shape_spec, T.QWEN_IMAGE_20B_DIMS,
                          tp_spec.qwen_image_rules()),
        "wan": ent(T.wan_shape_spec, T.WAN_14B_DIMS, tp_spec.wan_rules()),
        "hyvid": ent(T.hyvid_shape_spec, T.HYVID_13B_DIMS,
                     tp_spec.hyvid_rules(T.HYVID_13B_DIMS.hidden)),
        "aura": ent(T.aura_shape_spec, T.AURA_V03_DIMS,
                    tp_spec.aura_rules()),
        "lumina2": ent(T.lumina2_shape_spec, T.LUMINA2_DIMS,
                       tp_spec.lumina2_rules(T.LUMINA2_DIMS.dim)),
        "cosmos": ent(T.cosmos_shape_spec, T.COSMOS_7B_DIMS,
                      tp_spec.cosmos_rules()),
        "hidream": ent(T.hidream_shape_spec, T.HIDREAM_I1_DIMS,
                       tp_spec.hidream_rules(T.HIDREAM_I1_DIMS.n_experts)),
    }


def _card_budget_gb():
    import torch

    if not torch.cuda.is_available():
        return None
    total = torch.cuda.get_device_properties(0).total_memory
    return total / 1e9 - CARD_MARGIN_GB


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="per-card packed-weight budget (default: the "
                         "card's memory less CARD_MARGIN_GB)")
    ap.add_argument("--qtype", default="Q4_K")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..gguf.constants import GGMLQuantizationType as Q
    from ..parallel import tp_spec

    budget_gb = args.budget_gb
    if budget_gb is None:
        budget_gb = _card_budget_gb()
        if budget_gb is None:
            print("error: no CUDA device to size the budget from; pass "
                  "--budget-gb", file=sys.stderr)
            return 2
    qtype = getattr(Q, args.qtype)
    budget = budget_gb * 1e9
    specs = _specs()
    archs = [args.arch] if args.arch else sorted(specs)
    rc = 0
    out = []
    for arch in archs:
        if arch not in specs:
            print(f"error: no TP spec for {arch!r}; have {sorted(specs)}",
                  file=sys.stderr)
            return 2
        groups, rules, heads = specs[arch]
        if not heads:
            print(f"error: {arch}: no head count, so no tp can be called "
                  "runnable", file=sys.stderr)
            rc = 2
            continue
        for tp in (1, 2, 4, 8):
            if heads % tp:
                continue  # heads do not divide: the mesh cannot run
            try:
                rep = tp_spec.i8_plan_report(groups, rules, tp=tp,
                                             qtype=qtype)
            except ValueError:
                continue
            row = {"arch": arch, "tp": tp,
                   "planar_gb_per_shard":
                       round(rep["planar_per_shard"] / 1e9, 2),
                   "i8_gb_per_shard": round(rep["i8_per_shard"] / 1e9, 2),
                   "fits_planar": rep["planar_per_shard"] < budget,
                   "fits_i8": rep["i8_per_shard"] < budget}
            out.append(row)
            if not args.json:
                print(f"{arch:12s} tp={tp}  planar "
                      f"{row['planar_gb_per_shard']:6.2f} GB/shard "
                      f"{'fits' if row['fits_planar'] else 'OVER'}   "
                      f"int8 {row['i8_gb_per_shard']:6.2f} GB/shard "
                      f"{'fits' if row['fits_i8'] else 'OVER'}"
                      f"   (budget {budget_gb:.2f} GB)")
    if args.json:
        print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
