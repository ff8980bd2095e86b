"""The launcher's side of a job that the port needs: the run's secret
key and the client of its HTTP key-value store."""
