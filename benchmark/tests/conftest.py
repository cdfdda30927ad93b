"""The tiny cells time windows of a few seconds on the CPU: each test
process keeps to two intra-op threads, so parallel workers do not crowd
each other's windows empty."""

import torch

torch.set_num_threads(2)
