"""A split ``<metric>.<cell's configuration>`` of a per-layer metric,
read by the reader of ``<metric>``: this file's name without its last
dotted part. The split has a file of its own so that a split of it in
turn (one more dotted part) finds a reader by name too."""

import os

from benchmark import spec

_HERE = os.path.abspath(__file__)
read = spec.metric(os.path.basename(_HERE)[:-3].rsplit(".", 1)[0],
                   os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
                   ).read
