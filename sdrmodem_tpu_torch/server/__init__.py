"""The sdr-modem TCP server on the port: wire protocol, configuration,
sessions and the asyncio front end."""
