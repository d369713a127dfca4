from repro_torch.parallel.sharding import (ShardingRules, activation_resolver,
                                           batch_specs, param_specs)

__all__ = ["ShardingRules", "activation_resolver", "batch_specs",
           "param_specs"]
