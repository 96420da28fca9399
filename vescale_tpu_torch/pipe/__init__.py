"""Pipeline helpers of the port (only the stage split the serve engine uses)."""
