"""A/B timing of the port's kernel ``fp8_gemm`` between two checkouts on
one card.

    python3 scripts/ab_fp8_gemm.py ROOT

times the kernel of ``ROOT/src/repro_torch`` (built into ``ROOT/build``)
at the OneRec and LM-zoo shapes of ``chip_smoke.py``'s phase 2: device
time of one call among calls captured in a CUDA graph, weights rotated
through a pool larger than L2, and the quantization pass alone; prints
one JSON line.  To compare a parent commit with a change, unpack the
parent with ``git archive`` into a directory ``.gitignore`` lists and run
parent, change, change, parent in one call on the card."""
import json
import math
import sys

ROOT = sys.argv[1]
sys.path.insert(0, ROOT + "/src")
import torch  # noqa: E402
from repro_torch.core import quant  # noqa: E402,F401
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fp8_gemm import ops  # noqa: E402

SHAPES = [(32, 2048, 2048), (32, 2048, 512), (4, 4096, 14336),
          (4, 14336, 4096), (4, 2048, 10944), (4, 10944, 2048),
          (4, 1152, 256), (12320, 2048, 2048)]


def graph_ms(fn, iters=20, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (iters * replays)


build.build_all()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(1)
out = {}
for m, k, n in SHAPES:
    x = torch.randn(1, m, k, device=dev, generator=gen).to(torch.bfloat16)
    n_w = -(-(100 << 20) // (k * n))
    ws = [quant.quantize_per_channel(torch.randn(
        1, k, n, device=dev, generator=gen) / math.sqrt(k))
        for _ in range(n_w)]
    sws = [w.scale.reshape(1, n).contiguous() for w in ws]
    it = [0]

    def kern():
        it[0] = (it[0] + 1) % n_w
        ops.fp8_gemm(x, ws[it[0]].data, sws[it[0]])

    _, _, xh, sx, _, _ = ops.scratch(x, ws[0].data)
    iters = 5 if m > 1024 else 50
    out[f"M={m} K={k} N={n}"] = dict(
        kernel=graph_ms(kern, iters),
        quant=graph_ms(lambda: ops.quantize_pass(x, xh, sx), iters))
print(json.dumps({"root": ROOT, "ms": out}))
