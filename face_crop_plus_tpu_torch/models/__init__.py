"""The networks of the port: detection (RetinaFace), enhancement (RRDBNet
x4), parsing (BiSeNet), each on a torch device with converted weights."""

from .detection import RetinaFace
from .enhancement import RRDBNet
from .parsing import BiSeNet

__all__ = ["BiSeNet", "RRDBNet", "RetinaFace"]
