"""The plain PyTorch reference of the port's default frame, which
decides ``correct``.

It imports nothing of the program.  Most files are frozen copies of the
port's plain versions (``ops/`` and ``utils/`` of
``soc_real_time_renderer_tpu_torch`` as this benchmark was written),
each with its hand kernel's plain version in the kernel's place and the
view-axis and row-band paths that a cell does not take left where they
do no harm; :mod:`.raster`, :mod:`.ssr`, :mod:`.globals` and
:mod:`.frame` say where the reference departs from the program.  Later changes to the program
do not move it.
"""
