"""Algorithm 1 of the paper on the port: split, selection, FedAvg,
meta-training, compose, and the round engine."""
