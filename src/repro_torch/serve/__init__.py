"""Serving of the port: sampling and the static prefill + decode loop."""
