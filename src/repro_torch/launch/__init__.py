"""Command-line entry points (``depam_run``, ``serve``, ``train``,
``dryrun``), host meshes (``mesh``) and the dry run's cell shapes
(``shapes``)."""
