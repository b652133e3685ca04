"""Learning-rate and sketch-size schedules."""
from repro_torch.optim.schedules import constant, cosine, inv_sqrt, sketch_size_schedule
