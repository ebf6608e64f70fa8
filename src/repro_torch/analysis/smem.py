"""Shared-memory budgets of the kernels' instances: ``repro/analysis/vmem.py``
for the H100.

JAX's ledger captured every ``pallas_call`` a step traced and summed its
BlockSpecs' VMEM. The port's kernels are CUDA C++ whose launches each
wrapper plans in Python, so a step run on the meta device under
``kernels/common.py::recorded_kernel_calls`` logs each kernel call with the
instance it would launch (``common.instance``: threads, grid, cluster,
dynamic and static shared memory, registers, resident CTAs per SM), from
the kernel's model of the H100. The budget is then that instance's own
shared memory, dynamic and static, against what one CTA may hold on the
card, :data:`SMEM_CEILING`, with at least one CTA resident per SM.
``chip_smoke.py``'s ``contracts`` phase holds each model to the card's
``instance_info``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

from repro_torch.kernels.common import H100

#: Shared memory one CTA may have on the H100: an SM's, less the 1 KB the
#: runtime reserves a CTA (232,448 B).
SMEM_CEILING = H100["smem_per_sm"] - H100["smem_reserved_per_cta"]


def smem_bytes(inst: Dict) -> int:
    """One CTA's shared memory, dynamic and static."""
    return inst["smem_dynamic"] + inst["smem_static"]


def fits(inst: Dict, ceiling: int = SMEM_CEILING) -> bool:
    """The instance's shared memory within ``ceiling`` and one CTA or more
    resident per SM."""
    return smem_bytes(inst) <= ceiling and inst["ctas_per_sm"] >= 1


def instances(calls: Sequence[Dict]) -> List[Dict]:
    """One record per distinct (call, instance), in call order: a step that
    launches the same instance twice (a stack's layers) budgets it once."""
    seen, out = set(), []
    for c in calls:
        rec = {"call": c["name"], **c["instance"]}
        key = json.dumps(rec, sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(rec)
    return out


def launches(calls: Sequence[Dict]) -> Dict[str, int]:
    """CUDA launches a step makes, by kernel call name."""
    out: Dict[str, int] = {}
    for c in calls:
        out[c["name"]] = out.get(c["name"], 0) + c["launches"]
    return dict(sorted(out.items()))


def card_instance(inst: Dict) -> Dict:
    """The card's report of ``inst`` (its wrapper's ``instance_info`` at
    ``inst["args"]``): dynamic shared memory, registers and resident CTAs
    per SM, and static shared memory where the card reports it (B3, B4's
    one-step kernels). Builds and loads the kernel's library: on the card
    only."""
    import torch

    from repro_torch.kernels.fused_rnn import fused_rnn
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.ssd import ssd

    args, kernel = inst["args"], inst["kernel"]
    static = None
    if kernel.startswith("fused_rnn_mma_kernel"):
        info = fused_rnn.instance_info(**args)
    elif kernel.startswith("fused_rnn_layer_kernel"):
        info = fused_rnn.simt_instance_info(**{**args, "w_dtype": getattr(torch, args["w_dtype"])})
    elif kernel.startswith("linear_scan"):
        info = linear_scan.instance_info(args["T"], args["F"], getattr(torch, args["dtype"]),
                                         args["backward"], args["aligned4"])
        static = info["static_smem_bytes"]
    elif kernel.startswith("ssd_step"):
        info = ssd.step_instance_info(getattr(torch, args["x_dtype"]),
                                      getattr(torch, args["bc_dtype"]), args["vec"])
        static = info["static_smem_bytes"]
    elif kernel.startswith("ssd_chunk"):
        info = ssd.instance_info(getattr(torch, args["x_dtype"]), getattr(torch, args["bc_dtype"]),
                                 args["state_size"])
    elif kernel.startswith("gqa_decode"):
        info = gqa_decode.instance_info(getattr(torch, args["dtype"]), args["head_dim"],
                                        args["group"])
    else:
        raise ValueError(f"no card report for kernel {kernel}")
    out = {"smem_dynamic": info["smem_bytes"], "registers": info["registers"],
           "ctas_per_sm": info["ctas_per_sm"]}
    if static is not None:
        out["smem_static"] = static
    return out
