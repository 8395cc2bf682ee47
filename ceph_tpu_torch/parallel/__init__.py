"""Distribution layer: messenger, CRUSH, OSD map, mon (host side).

The reference scales via placement parallelism (CRUSH), EC striping across
OSDs, and a messenger over TCP (SURVEY.md §2.3, §5). Host-side control
and placement stay in Python; the multi-device route (meshes, sharded
codecs) is not ported yet (ROADMAP A.5).
"""
