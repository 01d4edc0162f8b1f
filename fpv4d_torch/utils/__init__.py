from fpv4d_torch.utils import monitor, observability, checkpoint
