"""A/B timing of the port's kernel ``batch_attention`` between two
checkouts on one card.

    python3 scripts/ab_batch_attention.py ROOT

times the kernel of ``ROOT/src/repro_torch`` (built into ``ROOT/build``)
at ``chip_smoke.py``'s phase-2 shapes: OneRec-V2's decode (B = 32, S =
388, ragged rows) and the LM zoo's shared-index decode at S = 4112, bf16
K/V; and OneRec-V2's decode over an fp8 cache as the contiguous decode
reads it, through the kernel's fp8 mode where ``ROOT`` has one, else
``_read_kv``'s dequantization and then the bf16 kernel.  Device time of
one call among calls captured in a CUDA graph, the caches rotated through
a pool larger than L2 (each decode layer reads its own cache).  Prints
one JSON line, with a hash of the bf16 OneRec output (one split in both
checkouts: the same bits mean the same rounding).  To compare a parent
commit with a change, unpack the parent with ``git archive`` into a
directory ``.gitignore`` lists and run parent, change, change, parent in
one call on the card."""
import hashlib
import inspect
import json
import math
import sys

ROOT = sys.argv[1]
sys.path.insert(0, ROOT + "/src")
import torch  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.batch_attention import ops  # noqa: E402
from repro_torch.layers.attention import _read_kv  # noqa: E402

POOL_BYTES = 120 << 20           # more than the H100's 50 MB of L2
ZOO = [("gemma3-1b local ring", 4, 4, 1, 256, 512, 512),
       ("gemma3-1b global", 4, 4, 1, 256, 4112, 0),
       ("llama3-8b", 4, 32, 8, 128, 4112, 0),
       ("qwen2-moe / deepseek-moe", 4, 16, 16, 128, 4112, 0),
       ("deepseek-coder-33b", 4, 56, 8, 128, 4112, 0)]
LAST = 4111


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


def pool(make, nbytes):
    """Copies of a cache, enough to pass L2, and a call on the next one."""
    return [make() for _ in range(max(1, -(-POOL_BYTES // nbytes)))]


def rotating(call, caches):
    it = [0]

    def fn():
        it[0] = (it[0] + 1) % len(caches)
        return call(*caches[it[0]])
    return fn


build.build_all()
dev = torch.device("cuda")
fp8_mode = "k_scale" in inspect.signature(ops.batch_attention).parameters
g = torch.Generator(device="cpu").manual_seed(5)
out = {}

# OneRec-V2's decode: 32 ragged rows of a 388-slot cache, H 16, Kv 4
b, h, kv, hd, s = 32, 16, 4, 128, 388
lengths = torch.randint(7, s, (b,), generator=g)
q = torch.randn(b, 1, h, hd, generator=g).to(torch.bfloat16).to(dev)
k_pos = torch.arange(s)[None].expand(b, s)
k_pos = torch.where(k_pos < lengths[:, None], k_pos, -1).to(
    torch.int32).contiguous().to(dev)
q_pos = (lengths[:, None] - 1).to(torch.int32).to(dev)
scale = 1.0 / math.sqrt(hd)


def onerec_cache():
    k = torch.randn(b, s, kv, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(b, s, kv, hd, generator=g).to(torch.bfloat16).to(dev)
    return k, v


caches = pool(onerec_cache, 2 * b * s * kv * hd * 2)
bf16 = rotating(lambda k, v: ops.batch_attention(
    q, k, v, q_pos, k_pos, scale=scale), caches)
first = ops.batch_attention(q, *caches[0], q_pos, k_pos, scale=scale)
out["onerec decode B=32 S=388"] = dict(bf16=graph_ms(bf16, 50))
sha = hashlib.sha256(first.view(torch.int16).cpu().numpy().tobytes())
fp8_caches = [(*quant.quantize_kv(k.float()), *quant.quantize_kv(v.float()))
              for k, v in caches]
if fp8_mode:
    fp8 = rotating(lambda k8, ks, v8, vs: ops.batch_attention(
        q, k8, v8, q_pos, k_pos, scale=scale, k_scale=ks, v_scale=vs),
        fp8_caches)
else:
    fp8 = rotating(lambda k8, ks, v8, vs: ops.batch_attention(
        q, *_read_kv(k8, v8, ks, vs, torch.bfloat16), q_pos, k_pos,
        scale=scale), fp8_caches)
out["onerec decode B=32 S=388"]["fp8" if fp8_mode else "read_kv+bf16"] = \
    graph_ms(fp8, 50)
del caches, fp8_caches

for name, b, h, kv, hd, s, window in ZOO:
    q = torch.randn(b, 1, h, hd, generator=g).to(torch.bfloat16).to(dev)
    pos = LAST - (LAST - torch.arange(s)) % s
    k_pos = pos.to(torch.int32)[None].expand(b, s).contiguous().to(dev)
    q_pos = torch.full((b, 1), LAST, dtype=torch.int32, device=dev)

    def zoo_cache():
        return tuple(torch.randn(b, s, kv, hd, generator=g).to(
            torch.bfloat16).to(dev) for _ in range(2))

    caches = pool(zoo_cache, 2 * b * s * kv * hd * 2)
    call = rotating(lambda k, v: ops.batch_attention(
        q, k, v, q_pos, k_pos, scale=1.0 / math.sqrt(hd), window=window),
        caches)
    out[f"{name} B={b} H={h} Kv={kv} hd={hd} S={s}"] = dict(
        bf16=graph_ms(call, 20), pool=len(caches))
    del caches
print(json.dumps({"root": ROOT, "fp8_mode": fp8_mode,
                  "onerec_bf16_sha256": sha.hexdigest()[:16], "ms": out}))
