from . import datasets
from . import transforms
from .loader import DataLoader
