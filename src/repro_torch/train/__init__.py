"""Training substrate of the port: optimizers, the train step, checkpoints,
the resilient driver, and distributed full-graph GNN training."""
