"""Config loading and flattening."""
