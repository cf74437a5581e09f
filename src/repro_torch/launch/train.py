"""Trainer CLI of the port: ``--arch <id>`` trains an LM or GNN arch at its
smoke config on the device.

Counterpart of ``repro.launch.train`` for the lm and gnn families:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --steps 3 --device cpu

Wiring: configs.registry -> train.steps builders -> a step loop timed by
``dist.fault_tolerance.StepMonitor``. LM archs train on ``lm_batch(seed=0,
step)`` of ``--batch`` x ``--seq`` tokens; GNN node tasks on
``symmetrize(rmat(10, 8, seed=0))`` with 16 features and 4 classes, graph
tasks on ``batched_molecules(step, 16 graphs of 16 nodes / 32 edges)``, as
the reference's runners do. The recsys family and ``--ckpt`` wait for their
slices (ROADMAP.md §1).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get
from repro_torch.device import resolve_device
from repro_torch.dist.fault_tolerance import StepMonitor
from repro_torch.train import steps as steps_mod
from repro_torch.train.optim import AdamWConfig

IN_DIM, OUT_DIM = 16, 4

_WAITS = {
    "recsys": "DIN training waits for its slice (ROADMAP.md §1, \"DIN training\")",
}


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="LM batch")
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke config (the default, as the reference's)")
    ap.add_argument("--ckpt", default=None,
                    help="not ported yet: waits for dist/{checkpoint,fault_tolerance}.py")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    arch = get(args.arch)
    if arch.family in _WAITS:
        raise SystemExit(f"--arch {args.arch}: {_WAITS[arch.family]}")
    if args.ckpt:
        raise SystemExit("--ckpt waits for the port of dist/{checkpoint,fault_tolerance}.py "
                         "(ROADMAP.md §1, \"Training infrastructure\")")
    dev = resolve_device(args.device)
    cfg = arch.smoke() if args.reduced else arch.model
    ocfg = AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=min(20, args.steps))
    if arch.family == "lm":
        init_state, step_fn = _lm_runner(cfg, ocfg, args.batch, args.seq, dev)
    else:
        init_state, step_fn = _gnn_runner(arch, cfg, ocfg, dev)

    monitor = StepMonitor()
    losses = []
    state = init_state()
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, i)
        loss = float(m["loss"])  # waits for the step to finish
        monitor.record(i, time.perf_counter() - t0)
        losses.append(loss)
        if i % 10 == 0:
            print(f"step {i:5d}  loss {loss:.4f}", flush=True)
    print(f"final: loss {losses[0]:.4f} -> {losses[-1]:.4f}; {monitor.summary()}")


if __name__ == "__main__":
    main()
