from repro_torch.analysis.roofline import (HW, collective_bytes,
                                           roofline_report, model_flops)

__all__ = ["HW", "collective_bytes", "roofline_report", "model_flops"]
