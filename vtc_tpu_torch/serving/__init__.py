"""Single-device retrieval serving of the port, and its HTTP front end."""

from .index import ClipRetrievalService, RetrievalIndex
from .server import RetrievalHTTPServer

__all__ = ["ClipRetrievalService", "RetrievalHTTPServer", "RetrievalIndex"]
