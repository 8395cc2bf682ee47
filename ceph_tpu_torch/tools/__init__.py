"""Command-line tools: the EC non-regression corpus, the ``ceph``,
``rados`` and ``rbd`` CLIs, ``vstart``, ``crushtool``, ``osdmaptool``,
``dencoder``, ``objectstore_tool``, ``flame`` and the analysis and trace
tools."""
