"""Architecture configs of the port (``--arch <id>``): the reference's
values, for the archs the port has (``din``)."""
