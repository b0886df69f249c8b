"""The routed experts' grouped products in the forward as a share of the
card's dense bf16 peak: their FLOPs a step (``counts_h21.expert_flops``:
every token through its top 2 experts, C -> 4C -> C, in each MoE block)
over the device time of the program's span ``h21.moe.experts`` a step
(the two grouped products and the GELU between them). None where the
program records no such span."""

from portbench import counts
from portbench.program_spans import per_root_ms


def read(run, params):
    flops = run.work.get("expert_flops_step")
    ms = per_root_ms(run, params["span"], params["per"])
    if not flops or not ms:
        return None
    peak, _ = counts.peaks(run.card)
    return 100.0 * flops / (ms * 1e-3) / peak
