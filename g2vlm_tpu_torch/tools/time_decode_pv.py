"""Times the decode step's probabilities-times-values product on one NVIDIA
GPU, as one matrix product and in the sliced form the port runs
(`ops.attention.probs_times_values`), at the chat slice's cache:

    python -m g2vlm_tpu_torch.tools.time_decode_pv [CACHE_ROWS]

p is (1, 2, 6, C) and v (1, 2, C, 128) in fp32, C = 48,896 by default (the
32-view prefill plus 512 rows): one decode step runs this product once per
layer, 28 times. Both forms are timed in turns, warm, with CUDA events, and
held equal to 1e-4 of max|whole|.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from g2vlm_tpu_torch.ops import attention


def _time_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 48896
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.rand(1, 2, 6, rows, generator=gen, device="cuda")
    v = torch.randn(1, 2, rows, 128, generator=gen, device="cuda")
    forms = {"whole": lambda: torch.matmul(p, v), "sliced": lambda: attention.probs_times_values(p, v)}
    whole, sliced = forms["whole"](), forms["sliced"]()
    rel = ((sliced - whole).abs().max() / whole.abs().max()).item()
    if rel > 1e-4:
        raise SystemExit(f"the two forms differ by {rel} of max|whole|")
    times = {name: [] for name in forms}
    for name in ("whole", "sliced", "sliced", "whole"):
        times[name].append(_time_ms(forms[name], 50))
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"{name}: {ms:.4f} ms per product, {28 * ms:.3f} ms per decode step of 28 layers "
              f"(p (1,2,6,{rows}) x v (1,2,{rows},128) fp32; {card})")
    print(f"max|sliced - whole| / max|whole| = {rel:.2e}")


if __name__ == "__main__":
    main()
