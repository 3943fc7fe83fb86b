"""Hardware-aware training of the port: the distillation losses, the train
step, the resumable trainer and the recipes."""
