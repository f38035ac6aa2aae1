from repro_torch.kernels.fcube.ops import project_fcube_fused, project_fcube_plain

__all__ = ["project_fcube_fused", "project_fcube_plain"]
