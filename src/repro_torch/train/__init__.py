from repro_torch.train.step import build_train_step, train_step_fn

__all__ = ["build_train_step", "train_step_fn"]
