from fpv4d_torch.ops import (chamfer_ref, chamfer_cuda, cand_cuda,
                             contact, losses, nn, sdf)
