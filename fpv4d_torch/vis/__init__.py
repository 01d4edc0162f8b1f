from fpv4d_torch.vis import raster, ego_overlay, world_view, export
