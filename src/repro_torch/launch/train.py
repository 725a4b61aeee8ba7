"""Training launcher of the port (the JAX package's
``repro/launch/train.py``).

Composes: config registry -> data pipeline -> train step
(``steps.train_step``: gradient, optional FP8 gradient compression with
error feedback, AdamW in place) -> fault-tolerant runner (async
checkpoints in the JAX format, restart, straggler watchdog).  Runs on the
card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch onerec-v2 \
      --reduced --steps 200 --ckpt-dir /tmp/onerec_ckpt [--compress-grads] \
      [--device cuda|cpu]

A second run with the same ``--ckpt-dir`` resumes from its newest valid
checkpoint, and one that finds the last step's takes no step.
"""

from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.lm import LMStreamConfig, SyntheticLMStream
from repro_torch.data.onerec_data import OneRecStreamConfig, SemanticIDStream
from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                          SyntheticInteractions)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.compression import ef_compress, ef_init
from repro_torch.distributed.fault_tolerance import (FaultTolerantRunner,
                                                     RunnerConfig)
from repro_torch.launch import steps
from repro_torch.models import onerec as onerec_model
from repro_torch.models import recsys as recsys_model
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimizerConfig, adamw_init


def build_training(arch: str, *, reduced: bool, batch: int, seq: int,
                   compress_grads: bool, opt_cfg: OptimizerConfig,
                   seed: int = 0, device=None):
    """Returns (init_state_fn, step_fn, batch_fn, cfg)."""
    mod = registry.get_arch(arch)
    cfg = mod.reduced_config() if reduced else mod.CONFIG
    return training_for(mod.FAMILY, cfg, batch=batch, seq=seq,
                        compress_grads=compress_grads, opt_cfg=opt_cfg,
                        seed=seed, device=device)


def training_for(family: str, cfg, *, batch: int, seq: int,
                 compress_grads: bool, opt_cfg: OptimizerConfig,
                 seed: int = 0, device=None, mesh=None
                 ) -> Tuple[Callable[[], Dict], Callable, Callable, Any]:
    """``build_training`` for a config of ``family`` (``lm``, ``onerec``
    or ``recsys``): (init_state_fn, step_fn, batch_fn, cfg).  The state is
    ``{"params", "opt": {"mu", "nu", "step"}, ["ef"]}`` on ``device``,
    the JAX train state's tree; ``step_fn(state, batch) -> (metrics,
    state)`` updates it in place.  With ``mesh`` (``recsys`` only, every
    rank calling alike) the state and each batch are laid out on it by
    their logical axes under ``TRAIN_RULES``, each rank holding its slices
    as ``DTensor``s, and the step runs sharded (``launch/steps.py``); the
    runner then checkpoints collectively (``checkpoint/store.py``)."""
    dev = resolve_device(device)
    if mesh is not None and (family != "recsys" or compress_grads):
        raise ValueError("a mesh takes the recsys family without "
                         f"compress_grads, not {family} "
                         f"(compress_grads={compress_grads})")
    if family == "lm":
        stream = SyntheticLMStream(LMStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed))
        loss_fn = partial(tfm.train_loss, cfg=cfg)
        init_params = lambda: tfm.init_transformer(          # noqa: E731
            steps._generator(seed, dev), cfg, device=dev)
    elif family == "onerec":
        stream = SemanticIDStream(OneRecStreamConfig(
            codebook_size=cfg.transformer.vocab_size - 64,
            history_len=cfg.history_len, global_batch=batch, seed=seed))
        loss_fn = partial(onerec_model.train_loss, cfg=cfg)
        init_params = lambda: onerec_model.init_onerec(      # noqa: E731
            seed, cfg, device=dev)
    elif family == "recsys":
        stream = SyntheticInteractions(RecsysStreamConfig(
            n_items=cfg.n_items, n_fields=cfg.n_sparse_fields,
            field_vocab=cfg.field_vocab, seq_len=cfg.seq_len,
            global_batch=batch, seed=seed))
        loss_fn = partial(recsys_model.train_loss, cfg=cfg)
        init_params = lambda: recsys_model.init_recsys(      # noqa: E731
            steps._generator(seed, dev), cfg, device=dev)
    else:
        raise ValueError(f"train.py does not drive family {family}")

    def init_state():
        params = init_params()
        state = {"params": params, "opt": adamw_init(params)}
        if compress_grads:
            state["ef"] = ef_init(params)
        if mesh is not None:
            state = {k: sh.lay_out_tree(v, steps.params_axes(v), mesh,
                                        sh.TRAIN_RULES)
                     for k, v in state.items()}
        return state

    ef: Dict[str, Any] = {}        # the step's residuals in, new ones out

    def compress(grads):
        grads, ef["new"] = ef_compress(grads, ef.pop("old"))
        return grads

    step = steps.train_step(loss_fn, opt_cfg,
                            compress if compress_grads else None)

    def step_fn(state, batch):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in batch.items()}
        if compress_grads:
            ef["old"] = state["ef"]
        if mesh is None:
            loss, params, opt = step(state["params"], state["opt"], batch)
        else:
            batch = sh.lay_out_tree(
                batch, steps.batch_axes(batch, steps._RECSYS_BATCH_AXES),
                mesh, sh.TRAIN_RULES)
            with sh.use_mesh(mesh, sh.TRAIN_RULES):
                loss, params, opt = step(state["params"], state["opt"],
                                         batch)
        new_state = {"params": params, "opt": opt}
        if compress_grads:
            new_state["ef"] = ef.pop("new")
        return {"loss": loss, **step.metrics}, new_state

    return init_state, step_fn, stream.batch_at, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="onerec-v2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                              total_steps=args.steps)
    init_state, step_fn, batch_fn, cfg = build_training(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq,
        compress_grads=args.compress_grads, opt_cfg=opt_cfg,
        device=args.device)

    runner = FaultTolerantRunner(
        step_fn, batch_fn, init_state,
        RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir))
    t0 = time.time()
    state, summary = runner.run()
    losses = [float(m["loss"]) for m in summary["metrics"]]
    if not losses:        # resumed at the last step: nothing to summarize
        print(f"[train] arch={args.arch} steps={args.steps} restored step "
              f"{args.steps} from {args.ckpt_dir}: no step taken")
        return state, summary
    print(f"[train] arch={args.arch} steps={args.steps} "
          f"wall={time.time()-t0:.1f}s "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first10 {np.mean(losses[:10]):.4f} last10 "
          f"{np.mean(losses[-10:]):.4f}) restarts={summary['restarts']} "
          f"stragglers={len(summary['stragglers'])}")
    return state, summary


if __name__ == "__main__":
    main()
