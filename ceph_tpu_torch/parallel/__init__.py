"""Distribution layer: device meshes, sharded codecs, messenger, CRUSH, OSD map, mon.

The reference scales via placement parallelism (CRUSH), EC striping across
OSDs, and a messenger over TCP (SURVEY.md §2.3, §5). Stripe batches and
chunk bytes split over a mesh of device slots (``mesh.py``,
``mesh_compile.py``, ``sharded_codec.py``, ``placement.py``), driven by
one process; host-side control and placement stay in Python.
"""
