"""The port's models. Only DIN (``models.recsys.din``) so far, with the MLP
helpers it uses (``models.gnn.common``)."""
