"""Scripts that measure the port on the card; nothing in the package imports them."""
