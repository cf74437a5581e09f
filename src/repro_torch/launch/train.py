"""Trainer CLI of the port: ``--arch <id>`` trains an LM, GNN or DIN arch at
its smoke config on the device.

Counterpart of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch din --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50 \
        --ckpt results/ckpt --ckpt-every 10

Wiring: configs.registry -> train.steps builders -> a step loop timed by
``dist.fault_tolerance.StepMonitor``; with ``--ckpt DIR`` the loop is
``dist.fault_tolerance.run_with_recovery`` (``dist.checkpoint``): a save
after every ``--ckpt-every`` steps, and a rerun with the same arguments
resumes from the newest complete checkpoint under DIR (a ``.tmp`` left by a
killed save is ignored) and runs to ``--steps``. LM archs train on ``lm_batch(seed=0,
step)`` of ``--batch`` x ``--seq`` tokens; GNN node tasks on
``symmetrize(rmat(10, 8, seed=0))`` with 16 features and 4 classes, graph
tasks on ``batched_molecules(step, 16 graphs of 16 nodes / 32 edges)``; DIN
on ``recsys_batch(0, step)`` of ``--batch`` users, the item rows by a take;
as the reference's runners do. Every batch is a pure function of the step,
so a resumed run sees the batches an uninterrupted one would. The last
line: the first and last loss of this run, the monitor's summary, the last
loss in full and the launches of the port's kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import ARCHS, get
from repro_torch.device import resolve_device
from repro_torch.dist.checkpoint import latest_step
from repro_torch.dist.fault_tolerance import CheckpointPolicy, StepMonitor, run_with_recovery
from repro_torch.train import steps as steps_mod
from repro_torch.train.optim import AdamWConfig

IN_DIM, OUT_DIM = 16, 4


def _lm_runner(cfg, ocfg, batch, seq, device):
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.transformer import init_params

    train = steps_mod.make_lm_train_step(cfg, ocfg)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return steps_mod.init_train_state(init_params(cfg, gen, device), ocfg)

    def step_fn(state, i):
        b = lm_batch(seed=0, step=i, batch=batch, seq=seq, vocab=cfg.vocab)
        return train(state, {k: torch.from_numpy(v).to(device) for k, v in b.items()})

    return init_state, step_fn


def _gnn_runner(arch, cfg, ocfg, device):
    import repro_torch.core.graph as G
    from repro_torch.data.synthetic import batched_molecules, graph_batch_from_coo
    from repro_torch.models.gnn import archs as gnn

    task = "graph_class" if arch.gnn_task == "graph_class" else "node_class"
    train = steps_mod.make_gnn_train_step(cfg, ocfg, task=task)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return steps_mod.init_train_state(gnn.init(cfg, IN_DIM, OUT_DIM, gen, device), ocfg)

    if task == "graph_class":
        def step_fn(state, i):
            b, lab = batched_molecules(i, n_graphs=16, nodes_per=16, edges_per=32, d_feat=16)
            return train(state, b.to(device), torch.from_numpy(lab % OUT_DIM).to(device))
    else:
        g = G.symmetrize(G.rmat(10, 8, seed=0))
        b, lab = graph_batch_from_coo(g.src, g.dst, g.num_vertices, IN_DIM, n_classes=OUT_DIM)
        b, lab = b.to(device), torch.from_numpy(lab).to(device)

        def step_fn(state, i):
            return train(state, b, lab)

    return init_state, step_fn


def _din_runner(cfg, ocfg, batch, device):
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models.recsys import din

    train = steps_mod.make_din_train_step(cfg, ocfg)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        return steps_mod.init_train_state(din.init(cfg, gen, device), ocfg)

    def step_fn(state, i):
        b = recsys_batch(0, i, batch, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab,
                         cfg.profile_bag_len)
        return train(state, din.batch_to(b, device))

    return init_state, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="LM or DIN batch")
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke config (the default, as the reference's)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: save every --ckpt-every steps, resume from it")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    arch = get(args.arch)
    dev = resolve_device(args.device)
    cfg = arch.smoke() if args.reduced else arch.model
    ocfg = AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=min(20, args.steps))
    if arch.family == "lm":
        init_state, step_fn = _lm_runner(cfg, ocfg, args.batch, args.seq, dev)
    elif arch.family == "gnn":
        init_state, step_fn = _gnn_runner(arch, cfg, ocfg, dev)
    else:
        init_state, step_fn = _din_runner(cfg, ocfg, args.batch, dev)

    monitor = StepMonitor()
    losses = []

    def wrapped(state, i):
        state, m = step_fn(state, i)
        loss = float(m["loss"])  # waits for the step to finish
        losses.append(loss)
        if i % 10 == 0:
            print(f"step {i:5d}  loss {loss:.4f}", flush=True)
        return state, m

    if args.ckpt:
        resume = latest_step(args.ckpt)
        print(f"resume: {'none' if resume is None else f'step {resume}'} under {args.ckpt}",
              flush=True)
        policy = CheckpointPolicy(directory=args.ckpt, every_steps=args.ckpt_every)
        run_with_recovery(wrapped, init_state, args.steps, policy, monitor=monitor)
    else:
        state = init_state()
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, _ = wrapped(state, i)
            monitor.record(i, time.perf_counter() - t0)
    if not losses:
        print(f"final: no step left to run (the checkpoint is at --steps {args.steps}); "
              f"{monitor.summary()}")
        return
    print(f"final: loss {losses[0]:.4f} -> {losses[-1]:.4f}; {monitor.summary()}; "
          f"last loss {losses[-1]!r}; launches {json.dumps(_kernel_launches())}")


def _kernel_launches() -> dict:
    """Launch counts of the port's kernels in this process, by kernel."""
    from repro_torch.kernels.embedding_bag import kernel as bag
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_softmax import kernel as softmax
    from repro_torch.kernels.segment_sum import kernel as segsum

    return {name: dict(mod.LAUNCHES) for name, mod in
            (("embedding_bag", bag), ("flash_attention", flash), ("segment_softmax", softmax),
             ("segment_sum", segsum))
            if mod.LAUNCHES}


if __name__ == "__main__":
    main()
