from repro_torch.runtime.elastic import ElasticRuntime, FailureEvent

# The reference also exports ControllerConfig and ReplanController
# (runtime/controller.py); they join this package with the simulator's
# evaluation layer, which the controller calls back into.
__all__ = ["ElasticRuntime", "FailureEvent"]
