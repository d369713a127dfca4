"""Quickstart: the Hulk pipeline on the paper's Fig. 1 eight-machine fleet.

1. Build the cluster graph (regions, compute, memory; Table 1 latencies).
2. Train the edge-pooling GCN on cost-model-labeled fleets (paper SS4).
3. Run Algorithm 1 to split the fleet across two tasks (GPT-2 + BERT-large,
   paper SS5.1) and compare the step time against Systems A/B/C.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch import _device
from repro_torch.core import assign, baselines, cost_model as cm
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import paper_fig1_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    tasks = [cm.GPT2_1_5B, cm.BERT_LARGE]
    graph = paper_fig1_graph()
    print(f"fleet: {graph.n} machines, "
          f"{sum(m.n_gpus for m in graph.machines)} GPUs")

    # Train the GNN (paper Fig. 4 setting: lr 0.01; sparse labels)
    cfg = gnn_train.gnn_config_for(tasks)
    dataset = gnn_train.make_dataset(4, tasks, n_nodes=8, seed=1,
                                     label_frac=0.8)
    dataset.append(gnn_train.make_example(graph, tasks, seed=0))
    # joint default mode: ~5x the old sequential epoch count (1 update/epoch)
    params, hist = gnn_train.train_gnn(cfg, dataset, steps=100, lr=0.01,
                                       device=device)
    print(f"GNN trained: acc {hist[0]['accuracy']:.2f} -> "
          f"{hist[-1]['accuracy']:.2f}")

    # Algorithm 1: task assignments (the GNN runs where its params lie)
    a = assign.task_assignments(graph, tasks, params, cfg)
    for name, ids in a.groups.items():
        regions = [graph.machines[i].region for i in ids]
        print(f"  {name}: machines {ids} ({', '.join(regions)})")

    # Compare against the paper's baselines (alpha-beta comm model: the
    # paper's literal ms/64B model gives astronomically large absolute WAN
    # numbers; relative improvements match)
    rows = baselines.compare_all(graph, tasks, params, cfg,
                                 comm_model="alphabeta")
    print(f"\n{'system':10s} {'comm s':>10s} {'compute s':>10s} {'total s':>10s}")
    for name in ("Hulk", "SystemA", "SystemB", "SystemC"):
        r = rows[name]
        print(f"{name:10s} {r['comm']:10.2f} {r['compute']:10.2f} "
              f"{r['total']:10.2f}")
    print(f"\nimprovement vs best baseline: "
          f"{rows['improvement_vs_best_baseline']:.1%}")


if __name__ == "__main__":
    main()
