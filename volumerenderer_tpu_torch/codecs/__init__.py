"""Volume codecs of the PyTorch port: the progressive kd-tree, built on the
host (numpy) and decoded on the tree's device (torch).

Counterpart of ``volumerenderer_tpu/codecs/`` (``kdtree.py`` and
``device.py``)."""
