"""The busiest held expert's top-k assignments over the held experts' mean,
in %, from the program's device counter ``moe.assignments``
(``dr4sr_tpu_torch/utils/spans.py``), read once after the traced steps:
100 is an even load; the grouped products wait on the largest group.
Moves ``train_seq_per_s``.

None where the trace's work has no training steps. Where it has them but
no counter (a program without it) or the counter saw no assignment, 0.0,
and the absence goes to standard error, as a span readers' absent span."""

import harness


def read(trace):
    if not trace.work.get("train_steps"):
        return None
    counts = trace.work.get("expert_assignments")
    if not counts or sum(counts) <= 0:
        harness.log("expert_load_max.moe: counter moe.assignments not in this run")
        return 0.0
    return 100.0 * max(counts) / (sum(counts) / len(counts))
