"""Data of the port: the synthetic Markov corpus and teacher-sampled
synthetic sequences (stage 1 of the paper's pipeline)."""
