from repro_torch.kernels.scube.ops import project_scube_fused, project_scube_plain

__all__ = ["project_scube_fused", "project_scube_plain"]
