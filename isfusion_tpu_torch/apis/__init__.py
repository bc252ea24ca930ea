from .inference import inference_detector, init_model
from .test import single_device_test
from .train import set_random_seed, train_model

__all__ = ["inference_detector", "init_model", "single_device_test",
           "set_random_seed", "train_model"]
