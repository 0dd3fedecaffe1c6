from .optimizers import AdamState, FactorState, Optimizer, adafactor, adam, get_optimizer, sgd

__all__ = ["Optimizer", "sgd", "AdamState", "adam", "FactorState", "adafactor", "get_optimizer"]
