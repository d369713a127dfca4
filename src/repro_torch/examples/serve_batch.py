"""Batched serving example: prefill a batch of prompts through gemma3-1b
(reduced) and greedy-decode continuations: the serve step that the decode_*
dry-run shapes price at production scale. On the card the prefill runs the
hand-written flash attention and the decode steps replay one captured graph
of the decode step (decode attention kernel).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import _device
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import SyntheticConfig, make_batch
from repro_torch.launch.serve import serve_batch
from repro_torch.models.registry import get_api


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = _device.resolve(args.device)

    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma3-1b")),
                              remat=False)
    api = get_api(cfg)
    params = api.init_params(cfg, seed=0, device=device)

    batch = make_batch(cfg, SyntheticConfig(global_batch=4, seq_len=32,
                                            seed=0), 0)
    gen, stats = serve_batch(cfg, params, batch, gen_tokens=16)
    print(f"batch of 4 requests -> 16 tokens each "
          f"({stats['tokens_per_s']:.1f} decode tok/s)")
    for i, row in enumerate(gen):
        print(f"  request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
