from gns_torch.train.trainer import TrainState, make_train_step, train  # noqa: F401
