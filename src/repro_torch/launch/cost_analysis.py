"""Collective bytes, the three-term roofline and the memory record.

The port's counterpart of the reference's `launch/hlo_analysis.py`,
which reads compiled HLO.  Nothing is compiled here:

  * `collective_bytes` sums, per collective kind, the result bytes of
    the `torch.distributed` calls that `analysis.trace.
    CollectiveRecorder` recorded (each call's sixth field), on the
    reference's convention: the bytes of the result on the calling
    rank (an all-reduce's tensor, an all-gather's gathered output, a
    reduce-scatter's shard, an all-to-all's received buffers, a
    point-to-point message);
  * `Roofline` is the reference's, `as_dict` keys unchanged, so one
    roofline reader takes both packages' records;
  * `memory_analysis_dict` gives the reference's memory keys from the
    dry run's arguments and outputs (exact, from the specs) and the
    counting mode's temp peak (`launch/counting.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: each recorded `torch.distributed` call's kind, by the result it
#: leaves on the calling rank (a barrier moves nothing and is counted
#: only under "count")
CALL_KINDS = {
    "all_reduce": "all-reduce", "reduce": "all-reduce",
    "broadcast": "all-reduce",
    "all_gather": "all-gather", "all_gather_into_tensor": "all-gather",
    "gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "scatter": "reduce-scatter",
    "all_to_all": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "isend": "collective-permute", "irecv": "collective-permute",
}


def collective_bytes(calls) -> Dict[str, int]:
    """Per-kind result bytes (on the calling rank) of recorded calls,
    and their "count"."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for call in calls:
        name, nbytes = call[0], call[5]
        kind = CALL_KINDS.get(name)
        if kind is not None:
            out[kind] += int(nbytes)
        out["count"] += 1
    return out


@dataclasses.dataclass
class Roofline:
    """Three-term roofline of one (arch x shape x mesh) cell.

    All terms are seconds a step for ONE device running its share:
    global work / (chips * rate)."""
    flops: float              # per-device flops
    hbm_bytes: float          # per-device bytes accessed
    coll_bytes: float         # per-device collective bytes
    peak_flops: float
    hbm_bw: float
    link_bw: float

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower bound assuming perfect overlap: max of the three."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time,
        }


def memory_analysis_dict(argument_bytes: int, output_bytes: int,
                         count: dict, alias_bytes: int = 0) -> dict:
    """The reference's memory keys of one device: its arguments and
    outputs (`alias` of them the outputs written into arguments), and
    the temp peak that the counting mode tracked (`count["temp peak
    bytes"]`: the storages the step allocated, live at once)."""
    return {"argument_size_in_bytes": int(argument_bytes),
            "output_size_in_bytes": int(output_bytes),
            "temp_size_in_bytes": int(count["temp peak bytes"]),
            "alias_size_in_bytes": int(alias_bytes)}
