from repro_torch.runtime.elastic import ElasticRuntime, FailureEvent
from repro_torch.runtime.controller import ControllerConfig, ReplanController

__all__ = ["ElasticRuntime", "FailureEvent", "ControllerConfig",
           "ReplanController"]
