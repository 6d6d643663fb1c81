"""Training substrate of the port: optimizers, the train step, checkpoints,
the resilient driver, distributed full-graph GNN training and xDeepFM
training."""
