from .base import Output
from .file import FileOutput
from .zmq_out import ZmqOutput
from .edi_out import EdiOutput

__all__ = ["Output", "FileOutput", "ZmqOutput", "EdiOutput"]
