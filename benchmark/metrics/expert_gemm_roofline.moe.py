"""The held experts' grouped products' share of their roofline: the least
time of the gate, up and down products, forward and backward, over the
rows the traced steps routed to the held experts
(``arith_moe.expert_gemm_bound_s``), over the device time of the slice's
matrix-product kernels (names with "gemm") of those that the MoE layer's
grouped products launched alone (the probe ``moe_experts``). Remat's
recomputed forward counts in the time and not in the bound. Moves
``train_seq_per_s``.

None where the trace's work has no training steps. Where it has them but
no expert bound (a program without the load counter ``moe.assignments``)
or the probe launched no such kernel, the experts count nothing: 0.0, and
what was missing goes to standard error, as a span readers' absent span."""

import harness


def read(trace):
    if not trace.work.get("train_steps"):
        return None
    bound = trace.work.get("expert_gemm_bound_s")
    kernels = [k for k in trace.probed_kernels("moe_experts") if "gemm" in k[0].lower()]
    device = sum(end - start for _, start, end in kernels) / 1e6
    if not bound or device <= 0:
        harness.log("expert_gemm_roofline.moe: " + ("no expert bound in this run's work"
                                                    if not bound else
                                                    "no grouped product in the probe"))
        return 0.0
    counts = {}
    for name, _, _ in kernels:
        counts[name] = counts.get(name, 0) + 1
    harness.log(f"expert_gemm_roofline.moe: {device!r} s on the device in {counts}")
    return 100.0 * bound / device
