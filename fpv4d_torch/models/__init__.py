from fpv4d_torch.models import params, smplx, vposer, motion_gru, cvae
