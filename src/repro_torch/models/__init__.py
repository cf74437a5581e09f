"""The port's models: the LM family (``models.layers``,
``models.transformer``), the GNNs (``models.gnn``) and DIN
(``models.recsys.din``)."""
