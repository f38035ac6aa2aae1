"""Command-line entry points of the port: ``train``, ``serve``,
``serve_ffcz``, and the multi-pod dry run ``dryrun`` (``python -m
repro_torch.launch.dryrun``: every (arch x shape x mesh) cell's step counted
on one rank of a fake process group by ``hlo_cost``), with the meshes
(``mesh``), input specs (``specs``) and step builders (``steps``) they use.
"""
