"""Core analog-foundation-model ops (the paper's contribution): the analog
linear op with its training rules, the quantizers, noise and clipping."""

from repro_torch.core.analog import (AnalogConfig, AnalogCtx, analog_linear,
                                     init_linear, linear_labels,
                                     pack_int4_weights,
                                     perturb_analog_weights,
                                     quantize_for_digital)

__all__ = ["AnalogConfig", "AnalogCtx", "analog_linear", "init_linear",
           "linear_labels", "pack_int4_weights", "perturb_analog_weights",
           "quantize_for_digital"]
