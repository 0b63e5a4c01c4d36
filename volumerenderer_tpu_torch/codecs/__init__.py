"""Volume codecs of the PyTorch port: the progressive kd-tree (built on the
host, or with its passes on the device by ``device_build``, and decoded on
the tree's device), the mid-range tree, the Morton-hashed kd-tree (built on
the host, natively on a machine with a CUDA device; decoded on the device)
and the octree (host numpy).

Counterpart of ``volumerenderer_tpu/codecs/`` (``kdtree.py``, ``device.py``,
``device_build.py``, ``diff.py``, ``midrange.py``, ``hashed.py`` and
``octree.py``)."""
