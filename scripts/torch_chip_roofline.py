"""Microbenchmark the card from PyTorch (counterpart of
scripts/chip_roofline.py): bf16 matmul TFLOP/s at several sizes (the
served and trained products among them), HBM copy bandwidth, and the
launch overhead (a small kernel launched back to back, and one launch
plus a host sync). Times are CUDA-event times on the card.

Usage: python scripts/torch_chip_roofline.py [--device cpu]
(on the CPU the same calls are timed on the host clock).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (m, k, n, calls timed): square, the 2400-row MLP/QKV products of a train
# step at batch 30, the LM head over 1200 rows, a decode step's 640 rows
MATMULS = [(8192, 8192, 8192, 4), (2400, 768, 3072, 64),
           (2400, 768, 2304, 64), (1200, 50257, 768, 8),
           (640, 768, 2304, 64)]
COPY_ELEMENTS = 256 * 1024 * 1024  # f32: 1 GB read and 1 GB written
COPY_REPS = 8
LAUNCHES = 1000


class Timer:
    """Elapsed ms of the calls between start() and stop(): CUDA events on
    a card, the host clock elsewhere."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]

    def start(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        import torch
        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize()
            return self.events[0].elapsed_time(self.events[1])
        return (time.perf_counter() - self.t0) * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    import torch

    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {"matmul_tflops": {}}

    # ---- matmul peak at several shapes -------------------------------------
    for (m, k, n, reps) in MATMULS:
        a = torch.randn(m, k, generator=gen, device=device).bfloat16()
        b = torch.randn(k, n, generator=gen, device=device).bfloat16()
        c = torch.empty(m, n, device=device, dtype=torch.bfloat16)
        torch.matmul(a, b, out=c)  # warm
        timer.start()
        for _ in range(reps):
            torch.matmul(a, b, out=c)
        dt = timer.stop() / 1e3 / reps
        tflops = 2 * m * k * n / dt / 1e12
        out["matmul_tflops"][f"{m}x{k}x{n}"] = tflops
        print(f"matmul [{m},{k}]x[{k},{n}]: {dt*1e3:.3f} ms  "
              f"{tflops:.1f} TFLOP/s", flush=True)
        del a, b, c

    # ---- HBM copy bandwidth -------------------------------------------------
    x = torch.randn(COPY_ELEMENTS, generator=gen, device=device)
    y = torch.empty_like(x)
    torch.mul(x, 1.000001, out=y)  # warm
    timer.start()
    for _ in range(COPY_REPS):
        torch.mul(x, 1.000001, out=y)  # reads x, writes y
    dt = timer.stop() / 1e3 / COPY_REPS
    gb = x.numel() * 4 * 2 / 1e9
    out["hbm_gb_per_s"] = gb / dt
    print(f"HBM rw {gb:.0f}GB: {dt*1e3:.2f} ms  {gb/dt:.0f} GB/s", flush=True)
    del x, y

    # ---- launch overhead ----------------------------------------------------
    z = torch.ones(8, 128, device=device)
    z.add_(1)
    timer.start()
    for _ in range(LAUNCHES):
        z.add_(1)
    per_launch = timer.stop() / LAUNCHES
    out["launch_us_back_to_back"] = per_launch * 1e3
    print(f"launch overhead, back to back: {per_launch*1e3:.2f} us/launch",
          flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    t0 = time.perf_counter()
    for _ in range(50):
        z.add_(1)
        sync()
    dispatch = (time.perf_counter() - t0) / 50
    out["dispatch_ms"] = dispatch * 1e3
    print(f"dispatch overhead (launch + sync): {dispatch*1e3:.3f} ms",
          flush=True)
    return out


if __name__ == "__main__":
    main()
