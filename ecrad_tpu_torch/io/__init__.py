"""File input and output of the port: NetCDF, the driver's input reader
and its output writers."""
