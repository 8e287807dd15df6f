"""The SCALA algorithm on tensors: label statistics, the split helpers,
the losses, and the split-step engine (:mod:`repro_torch.core.engine`)."""
