"""Evaluation of the port: the synthetic tasks and the paper's §3.2
noisy-eval protocol (mean ± std over simulated chip programmings)."""
