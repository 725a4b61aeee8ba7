"""The card's streaming rate for a decode attention's K/V read, apart from
any attention arithmetic.

    python3 scripts/stream_kv.py

builds ``scripts/stream_kv.cu`` with the kernels' ``nvcc`` flags into
``build/`` and reads the K and V of the LM zoo's qwen2-moe decode at S =
4112 (B = 4, Kv = 16, 256-byte rows of a head, 134.7 MB) as kernel
``batch_attention`` does at that shape, one KV head and half the keys a
block (128 blocks): by 16-byte ``cp.async`` into a 2-stage ring of
128-row tiles with unpadded rows and with rows padded by 16 bytes, by TMA
bulk copies of a row each, and by plain 16-byte loads of 1024 threads.
Event-timed launches back to back; prints the card and one line a way
with its microseconds and TB/s.  Needs a CUDA card and the toolkit."""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

WAYS = [(0, 256, "cp.async, unpadded rows"),
        (1, 256, "cp.async, rows padded by 16 bytes"),
        (2, 256, "TMA bulk copy a row"),
        (3, 1024, "plain 16-byte loads")]


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_kv: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lib_path = os.path.join(ROOT, "build", "stream_kv.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "scripts", "stream_kv.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).stream_kv
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    b, s, kv, splits = 4, 4112, 16, 2
    k = torch.randint(0, 255, (b, s, kv, 256), dtype=torch.uint8, device=dev)
    v = torch.randint(0, 255, (b, s, kv, 256), dtype=torch.uint8, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"{card}; {2 * k.numel() / 1e6:.1f} MB of K and V, "
          f"{kv * b * splits} blocks")
    for way, threads, name in WAYS:
        def call():
            code = fn(way, k.data_ptr(), v.data_ptr(), b, s, kv, splits,
                      threads, sink.data_ptr(), stream)
            if code:
                raise RuntimeError(f"stream_kv way {way}: CUDA error {code}")
        for _ in range(5):
            call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(30):
            call()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / 30 * 1e3
        print(f"{name} ({threads} threads): {us:.2f} us, "
              f"{2 * k.numel() / us / 1e6:.3f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
