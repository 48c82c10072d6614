"""The benchmark's general parts: the run of one cell (``runner``), the
profiler's reduction (``trace``), the instruments installed around the
program (``instruments``) and the meshes (``meshes``)."""
