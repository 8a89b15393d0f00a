from repro_torch.optim.optimizers import Optimizer, adamw, sgd
from repro_torch.optim.schedule import rescale_lr, step_decay, warmup_cosine
