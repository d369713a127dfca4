"""Geo-distributed placement end-to-end on the 46-server fleet (paper SS6):
four concurrent training jobs, scalability (join machine id 45, Fig. 6),
disaster recovery (two machines die), and the bridge to the production
pod mesh (placement.plan_runtime).

    PYTHONPATH=src python -m repro_torch.examples.geo_placement [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import _device
from repro_torch.core import cost_model as cm, placement
from repro_torch.core import train as gnn_train
from repro_torch.core.graph import Machine, paper_fleet46
from repro_torch.runtime import ElasticRuntime, FailureEvent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    tasks = cm.FOUR_TASKS
    fleet = paper_fleet46()
    cfg = gnn_train.gnn_config_for(tasks)
    ds = gnn_train.make_dataset(4, tasks, n_nodes=46, seed=1, label_frac=0.8)
    ds.append(gnn_train.make_example(fleet, tasks, seed=0))
    # joint default mode: ~5x the old sequential epoch count (1 update/epoch)
    params, _ = gnn_train.train_gnn(cfg, ds, steps=120, lr=0.01,
                                    device=device)

    rt = ElasticRuntime(fleet, tasks, params, cfg)
    print("initial groups:")
    for name, ids in rt.assignment.groups.items():
        print(f"  {name}: {len(ids)} machines -> {ids}")
    print(f"makespan: {rt.makespan():.2f}s/step\n")

    # --- scalability: the paper's Fig. 6 'machine id 45 {Rome, 7, 384}' ---
    report = rt.on_join(Machine("Rome", "V100", 12))
    print(f"join: node {report['node_id']} added "
          f"(rebalanced={report['rebalanced']})")

    # --- disaster recovery: two machines of the biggest group fail --------
    biggest = max(rt.assignment.groups, key=lambda k:
                  len(rt.assignment.groups[k]))
    victims = rt.assignment.groups[biggest][:2]
    report = rt.on_failure(FailureEvent(failed_ids=victims, at_step=1000))
    print(f"failure of {victims}: affected={report['affected_tasks']}, "
          f"restore-from-ckpt={report['restore_from_checkpoint']}, "
          f"deferred={report['deferred']}")
    print(f"makespan after recovery: {rt.makespan():.2f}s/step\n")

    # --- bridge to the production mesh: pods as graph nodes ---------------
    pods = [placement.PodSpec(f"pod{i}", r) for i, r in
            enumerate(["California", "Tokyo", "London", "California"])]
    lat = np.array([[0.0, 118.8, 132.3, 1.0],
                    [118.8, 0.0, 173.8, 118.8],
                    [132.3, 173.8, 0.0, 132.3],
                    [1.0, 118.8, 132.3, 0.0]], np.float32)
    pg = placement.pods_as_graph(pods, lat)
    plans = placement.plan_runtime(
        pg, {"OPT-175B": [0, 3], "T5-11B": [1, 2]},
        [cm.OPT_175B, cm.T5_11B])
    for p in plans:
        print(f"  {p.task}: pods {p.pods} cross-pod strategy="
              f"{p.pod_axis_strategy} "
              f"({p.est_cross_pod_bytes_per_step/1e9:.1f} GB/step)")


if __name__ == "__main__":
    main()
