from .checkpoint import restore, save
